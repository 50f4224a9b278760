"""A loopback stand-in for Google's token endpoint, the metadata server and
the Cloud Storage media download, for the tests of `io/gcs.py`: nothing
leaves 127.0.0.1.

`LoopbackGoogle()` serves, on a free loopback port:

  * `POST /token`: the JWT-bearer grant (answers `tok-sa`) and the
    refresh-token grant (`tok-user`);
  * `GET /` with `Metadata-Flavor: Google`: the metadata server's ping;
    `GET /computeMetadata/v1/instance/service-accounts/default/token`:
    `tok-gce`;
  * `GET /download/storage/v1/b/{bucket}/o/{name}?alt=media`: the bytes
    of `objects[(bucket, name)]`, 404 otherwise.

Every request is recorded in `requests` as (method, path with query,
headers as a lower-cased dict, form fields or None).
"""

import http.server
import json
import threading
import urllib.parse

TOKENS = {'urn:ietf:params:oauth:grant-type:jwt-bearer': 'tok-sa',
          'refresh_token': 'tok-user'}


class LoopbackGoogle:

  def __init__(self):
    self.objects = {}
    self.requests = []
    outer = self

    class Handler(http.server.BaseHTTPRequestHandler):

      def log_message(self, *args):  # quiet
        del args

      def _reply(self, status, body=b'', headers=()):
        self.send_response(status)
        for k, v in headers:
          self.send_header(k, v)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

      def _json(self, data):
        self._reply(200, json.dumps(data).encode(),
                    [('Content-Type', 'application/json')])

      def do_POST(self):  # pylint: disable=invalid-name
        length = int(self.headers.get('Content-Length', 0))
        form = dict(urllib.parse.parse_qsl(self.rfile.read(length).decode()))
        outer.requests.append(('POST', self.path, _headers(self), form))
        token = TOKENS.get(form.get('grant_type'))
        if self.path != '/token' or token is None:
          self._reply(400, b'bad grant')
          return
        self._json({'access_token': token, 'expires_in': 3600,
                    'token_type': 'Bearer'})

      def do_GET(self):  # pylint: disable=invalid-name
        headers = _headers(self)
        outer.requests.append(('GET', self.path, headers, None))
        parsed = urllib.parse.urlparse(self.path)
        flavor = headers.get('metadata-flavor') == 'Google'
        if parsed.path == '/' and flavor:
          self._reply(200, b'', [('Metadata-Flavor', 'Google')])
        elif parsed.path.startswith('/computeMetadata/v1/') and flavor:
          self._json({'access_token': 'tok-gce', 'expires_in': 3600,
                      'token_type': 'Bearer'})
        elif parsed.path.startswith('/download/storage/v1/b/'):
          bucket, _, name = parsed.path[len('/download/storage/v1/b/'):
                                        ].partition('/o/')
          key = (bucket, urllib.parse.unquote(name))
          if key in outer.objects:
            self._reply(200, outer.objects[key],
                        [('Content-Type', 'application/octet-stream')])
          else:
            self._reply(404, b'no such object')
        else:
          self._reply(404, b'')

    self.server = http.server.ThreadingHTTPServer(('127.0.0.1', 0), Handler)
    self.host = f'127.0.0.1:{self.server.server_address[1]}'
    self.url = f'http://{self.host}'
    self._thread = threading.Thread(target=self.server.serve_forever,
                                    daemon=True)
    self._thread.start()

  def close(self):
    self.server.shutdown()
    self.server.server_close()
    self._thread.join()


def _headers(handler) -> dict:
  return {k.lower(): v for k, v in handler.headers.items()}


def isolate(monkeypatch, tmp_path, server=None):
  """An environment where no credential is found by accident and every
  address `io/gcs.py` could reach is loopback: proxies off, gcloud's
  config an empty directory, the metadata server `server` (or a closed
  loopback port)."""
  for name in ('GOOGLE_APPLICATION_CREDENTIALS', 'STORAGE_EMULATOR_HOST',
               'API_ENDPOINT_OVERRIDE', 'GCE_METADATA_ROOT', 'http_proxy',
               'https_proxy', 'HTTP_PROXY', 'HTTPS_PROXY', 'ALL_PROXY',
               'all_proxy'):
    monkeypatch.delenv(name, raising=False)
  monkeypatch.setenv('NO_PROXY', '127.0.0.1,localhost')
  config = tmp_path / 'gcloud_config'
  config.mkdir(exist_ok=True)
  monkeypatch.setenv('CLOUDSDK_CONFIG', str(config))
  host = server.host if server is not None else '127.0.0.1:9'
  monkeypatch.setenv('GCE_METADATA_IP', host)
  monkeypatch.setenv('GCE_METADATA_HOST', host)
  return config
