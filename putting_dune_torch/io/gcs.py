"""The authenticated Cloud Storage download, over urllib (port of the JAX
package's `_gcs_authenticated_download`, which uses google-cloud-storage).

`download(bucket, blob, target)` finds credentials in the order
`google.auth.default` tries these three kinds:

  1. the JSON file at `GOOGLE_APPLICATION_CREDENTIALS`, then gcloud's
     `application_default_credentials.json` (under `CLOUDSDK_CONFIG`, else
     `~/.config/gcloud`):
       * `service_account`: an RS256-signed JWT (header typ, alg, kid;
         claims iat, exp = iat + 3600, iss, aud, scope, as google-auth's
         `service_account.Credentials` makes them) exchanged at the file's
         `token_uri` by the JWT-bearer grant;
       * `authorized_user`: the refresh-token grant (client_id,
         client_secret, refresh_token, scope) at its `token_uri`;
     other types (external_account, impersonated_service_account, ...)
     raise, naming the type;
  2. the metadata server: found by a GET of `http://$GCE_METADATA_IP`
     (169.254.169.254) answering `Metadata-Flavor: Google`; the token from
     `http://$GCE_METADATA_HOST/computeMetadata/v1/instance/
     service-accounts/default/token?scopes=...`.

The scopes are google-cloud-storage's `Client.SCOPE`. The object is then
read through the JSON API's media download,
`{endpoint}/download/storage/v1/b/{bucket}/o/{quoted name}?alt=media`,
with `Authorization: Bearer <token>`. As google-cloud-storage does,
`STORAGE_EMULATOR_HOST` replaces the endpoint and makes the request
anonymous, and `API_ENDPOINT_OVERRIDE` replaces it keeping the token.

The RSA signature (PKCS#1 v1.5, SHA-256) is `pow` over the key read from
its PEM (PKCS#8 `PRIVATE KEY` or PKCS#1 `RSA PRIVATE KEY`) by a small DER
reader: no crypto package.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import shutil
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional, Sequence, Tuple

SCOPES = (
    'https://www.googleapis.com/auth/devstorage.full_control',
    'https://www.googleapis.com/auth/devstorage.read_only',
    'https://www.googleapis.com/auth/devstorage.read_write',
)
TOKEN_URI = 'https://oauth2.googleapis.com/token'
JWT_GRANT_TYPE = 'urn:ietf:params:oauth:grant-type:jwt-bearer'
TOKEN_LIFETIME_SECONDS = 3600
STORAGE_ENDPOINT = 'https://storage.googleapis.com'
_METADATA_HEADERS = {'metadata-flavor': 'Google'}
_TIMEOUT = 30.0
# DER of the DigestInfo AlgorithmIdentifier of SHA-256 (RFC 8017, 9.2).
_SHA256_PREFIX = bytes.fromhex('3031300d060960864801650304020105000420')


class CredentialsError(RuntimeError):
  """No usable credentials, or a credential file this module refuses."""


class DownloadError(RuntimeError):
  """A token or media request failed."""


# --- RSA ---------------------------------------------------------------------


def _der(data: bytes, pos: int) -> Tuple[int, bytes, int]:
  """(tag, contents, next position) of the DER element at `pos`."""
  tag = data[pos]
  length = data[pos + 1]
  pos += 2
  if length & 0x80:
    count = length & 0x7F
    length = int.from_bytes(data[pos:pos + count], 'big')
    pos += count
  return tag, data[pos:pos + length], pos + length


def _der_sequence(data: bytes) -> list:
  items, pos = [], 0
  while pos < len(data):
    tag, body, pos = _der(data, pos)
    items.append((tag, body))
  return items


@dataclasses.dataclass(frozen=True)
class RsaKey:
  n: int
  e: int
  d: int
  p: int
  q: int
  dp: int
  dq: int
  qinv: int

  @property
  def size(self) -> int:
    return (self.n.bit_length() + 7) // 8


def _rsa_private_key(der: bytes) -> RsaKey:
  """An RSAPrivateKey (PKCS#1) DER body's integers."""
  tag, body, _ = _der(der, 0)
  if tag != 0x30:
    raise CredentialsError('RSA private key is not a DER sequence')
  items = _der_sequence(body)
  ints = [int.from_bytes(v, 'big') for t, v in items if t == 0x02]
  if len(ints) < 9 or ints[0] != 0:
    raise CredentialsError('not a two-prime RSA private key')
  return RsaKey(*ints[1:9])


def load_pem_private_key(pem: str) -> RsaKey:
  """An RSA key from a PKCS#8 `PRIVATE KEY` or PKCS#1 `RSA PRIVATE KEY`
  PEM."""
  lines = [l.strip() for l in pem.strip().splitlines() if l.strip()]
  if not lines or not lines[0].startswith('-----BEGIN '):
    raise CredentialsError('private_key is not a PEM')
  label = lines[0][len('-----BEGIN '):].rstrip('-')
  der = base64.b64decode(''.join(l for l in lines[1:]
                                 if not l.startswith('-----')))
  if label == 'RSA PRIVATE KEY':
    return _rsa_private_key(der)
  if label != 'PRIVATE KEY':
    raise CredentialsError(f'PEM {label!r} is not an unencrypted RSA key')
  tag, body, _ = _der(der, 0)
  items = _der_sequence(body) if tag == 0x30 else []
  if len(items) < 3 or items[2][0] != 0x04:
    raise CredentialsError('not a PKCS#8 private key')
  algorithm = _der_sequence(items[1][1])
  if not algorithm or algorithm[0][1] != bytes.fromhex('2a864886f70d010101'):
    raise CredentialsError('the PKCS#8 key is not rsaEncryption')
  return _rsa_private_key(items[2][1])


def rsa_sign_sha256(key: RsaKey, message: bytes) -> bytes:
  """The PKCS#1 v1.5 signature of SHA-256(message), by the CRT."""
  digest = _SHA256_PREFIX + hashlib.sha256(message).digest()
  pad = key.size - len(digest) - 3
  if pad < 8:
    raise CredentialsError('RSA key too small for a SHA-256 signature')
  m = int.from_bytes(b'\x00\x01' + b'\xff' * pad + b'\x00' + digest, 'big')
  s1 = pow(m, key.dp, key.p)
  s2 = pow(m, key.dq, key.q)
  h = (key.qinv * (s1 - s2)) % key.p
  return (s2 + h * key.q).to_bytes(key.size, 'big')


def _b64(data: bytes) -> bytes:
  return base64.urlsafe_b64encode(data).rstrip(b'=')


# --- credentials -------------------------------------------------------------


def _post_form(url: str, fields: Dict[str, str], timeout: float) -> dict:
  body = urllib.parse.urlencode(fields).encode('utf-8')
  request = urllib.request.Request(url, data=body, method='POST', headers={
      'Content-Type': 'application/x-www-form-urlencoded'})
  return _json_response(request, timeout)


def _json_response(request: urllib.request.Request, timeout: float) -> dict:
  try:
    with urllib.request.urlopen(request, timeout=timeout) as response:
      data = json.loads(response.read().decode('utf-8'))
  except urllib.error.HTTPError as e:
    raise DownloadError(f'{request.full_url}: HTTP {e.code} '
                        f'{e.read()[:200]!r}') from e
  if 'access_token' not in data:
    raise DownloadError(f'{request.full_url}: no access_token in the reply')
  return data


@dataclasses.dataclass
class ServiceAccount:
  """A service-account key file: the JWT-bearer grant."""
  info: dict
  scopes: Sequence[str] = SCOPES

  def __post_init__(self):
    for field in ('client_email', 'private_key', 'token_uri'):
      if field not in self.info:
        raise CredentialsError(f'service account info is missing {field}')
    self.key = load_pem_private_key(self.info['private_key'])

  def assertion(self, now: Optional[int] = None) -> bytes:
    """The signed JWT google-auth's service_account.Credentials makes."""
    now = int(time.time()) if now is None else int(now)
    header = {'typ': 'JWT', 'alg': 'RS256'}
    if self.info.get('private_key_id'):
      header['kid'] = self.info['private_key_id']
    payload = {'iat': now, 'exp': now + TOKEN_LIFETIME_SECONDS,
               'iss': self.info['client_email'], 'aud': TOKEN_URI,
               'scope': ' '.join(self.scopes)}
    segments = [_b64(json.dumps(header).encode('utf-8')),
                _b64(json.dumps(payload).encode('utf-8'))]
    signing_input = b'.'.join(segments)
    return signing_input + b'.' + _b64(rsa_sign_sha256(self.key,
                                                       signing_input))

  def token(self, timeout: float = _TIMEOUT) -> str:
    return _post_form(self.info['token_uri'], {
        'assertion': self.assertion().decode('ascii'),
        'grant_type': JWT_GRANT_TYPE}, timeout)['access_token']


@dataclasses.dataclass
class AuthorizedUser:
  """gcloud's user credentials: the refresh-token grant."""
  info: dict
  scopes: Sequence[str] = SCOPES

  def __post_init__(self):
    for field in ('client_id', 'client_secret', 'refresh_token'):
      if field not in self.info:
        raise CredentialsError(f'authorized user info is missing {field}')

  def token(self, timeout: float = _TIMEOUT) -> str:
    fields = {'grant_type': 'refresh_token',
              'client_id': self.info['client_id'],
              'client_secret': self.info['client_secret'],
              'refresh_token': self.info['refresh_token']}
    if self.scopes:
      fields['scope'] = ' '.join(self.scopes)
    return _post_form(self.info.get('token_uri', TOKEN_URI), fields,
                      timeout)['access_token']


def _metadata_host() -> str:
  return (os.environ.get('GCE_METADATA_HOST')
          or os.environ.get('GCE_METADATA_ROOT')
          or 'metadata.google.internal')


def _metadata_ip() -> str:
  return os.environ.get('GCE_METADATA_IP', '169.254.169.254')


@dataclasses.dataclass
class Metadata:
  """The metadata server's default service account."""
  scopes: Sequence[str] = SCOPES

  def token(self, timeout: float = _TIMEOUT) -> str:
    query = urllib.parse.urlencode({'scopes': ','.join(self.scopes)})
    url = (f'http://{_metadata_host()}/computeMetadata/v1/instance/'
           f'service-accounts/default/token?{query}')
    return _json_response(urllib.request.Request(
        url, headers=_METADATA_HEADERS), timeout)['access_token']


def metadata_server_available(timeout: float = 3.0) -> bool:
  """google-auth's ping: the metadata IP answers with its flavor header."""
  request = urllib.request.Request(f'http://{_metadata_ip()}',
                                   headers=_METADATA_HEADERS)
  try:
    with urllib.request.urlopen(request, timeout=timeout) as response:
      return (response.status == 200 and
              response.headers.get('metadata-flavor') == 'Google')
  except (OSError, ValueError):
    return False


def credentials_from_file(path: str, scopes: Sequence[str] = SCOPES):
  if not os.path.exists(path):
    raise CredentialsError(f'File {path} was not found.')
  with open(path) as f:
    info = json.load(f)
  kind = info.get('type')
  if kind == 'service_account':
    return ServiceAccount(info, scopes)
  if kind == 'authorized_user':
    return AuthorizedUser(info, scopes)
  raise CredentialsError(
      f'credential type {kind!r} in {path} is not supported by the port '
      '(service_account and authorized_user files, and the metadata '
      'server, are)')


def _gcloud_adc_path() -> str:
  config = os.environ.get('CLOUDSDK_CONFIG') or os.path.join(
      os.path.expanduser('~'), '.config', 'gcloud')
  return os.path.join(config, 'application_default_credentials.json')


def default_credentials(scopes: Sequence[str] = SCOPES):
  """The first credentials found, in google.auth.default's order."""
  explicit = os.environ.get('GOOGLE_APPLICATION_CREDENTIALS')
  if explicit:
    return credentials_from_file(explicit, scopes)
  adc = _gcloud_adc_path()
  if os.path.exists(adc):
    return credentials_from_file(adc, scopes)
  if metadata_server_available():
    return Metadata(scopes)
  raise CredentialsError(
      'Your default credentials were not found: set '
      'GOOGLE_APPLICATION_CREDENTIALS, run `gcloud auth application-default '
      'login`, or run on a machine with a metadata server.')


# --- the download ------------------------------------------------------------


def media_url(bucket: str, blob: str) -> Tuple[str, bool]:
  """(URL, whether to authenticate) of the object's media download."""
  emulator = os.environ.get('STORAGE_EMULATOR_HOST')
  if emulator:
    endpoint, authenticate = emulator, False
  else:
    endpoint = os.environ.get('API_ENDPOINT_OVERRIDE', STORAGE_ENDPOINT)
    authenticate = True
  if '://' not in endpoint:
    endpoint = 'http://' + endpoint
  name = urllib.parse.quote(blob.encode('utf-8'), safe=b'~')
  return (f'{endpoint.rstrip("/")}/download/storage/v1/b/{bucket}/o/{name}'
          '?alt=media', authenticate)


def download(bucket: str, blob: str, target: str, credentials=None,
             timeout: float = _TIMEOUT) -> None:
  """Writes gs://bucket/blob to `target`."""
  url, authenticate = media_url(bucket, blob)
  headers = {}
  if authenticate:
    credentials = credentials or default_credentials()
    headers['Authorization'] = f'Bearer {credentials.token(timeout)}'
    project = getattr(credentials, 'info', {}).get('quota_project_id')
    if project:
      headers['x-goog-user-project'] = project
  request = urllib.request.Request(url, headers=headers)
  try:
    with urllib.request.urlopen(request, timeout=timeout) as response, \
        open(target, 'wb') as out:
      shutil.copyfileobj(response, out)
  except urllib.error.HTTPError as e:
    raise DownloadError(f'gs://{bucket}/{blob}: HTTP {e.code}') from e
