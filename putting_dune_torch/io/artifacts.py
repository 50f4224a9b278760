"""Model-artifact bundles: zip archives with a hashed manifest.

Port of putting_dune_tpu/io/artifacts.py: a model directory (params.msgpack,
policy checkpoints and their metadata) travels as a zip with an embedded
sha256 manifest, so integrity comes from the archive rather than from the
channel. The archives are the JAX package's format: either package unpacks
the other's.

  python -m putting_dune_torch.io.artifacts pack \
      --model_dir=putting_dune_tpu/experiments/model_weights/atom_detector \
      --archive=atom_detector.zip
  python -m putting_dune_torch.io.artifacts unpack \
      --archive=atom_detector.zip --target_dir=/path/model_weights/

`resolve_artifact` also fetches gs:// (through the public HTTP endpoint)
and http(s):// bundles into a cache. A gs:// download the public endpoint
refuses falls back, as in the JAX package, to the authenticated download
(`io/gcs.py`: the JSON API over urllib with google-auth's credential
order, where the JAX package uses google-cloud-storage).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import time
import uuid
import zipfile
from typing import Dict

from putting_dune_torch.io import gcs

MANIFEST_NAME = 'MANIFEST.json'
# The JAX package's format name: archives cross between the packages.
_FORMAT = 'putting_dune_tpu-artifact-v1'


def _sha256(path: str) -> str:
  h = hashlib.sha256()
  with open(path, 'rb') as f:
    for chunk in iter(lambda: f.read(1 << 20), b''):
      h.update(chunk)
  return h.hexdigest()


def build_manifest(model_dir: str) -> Dict:
  """Walks a model directory into {relpath: {sha256, bytes}} + metadata."""
  files = {}
  for root, _, names in os.walk(model_dir):
    for name in sorted(names):
      if name == MANIFEST_NAME:
        continue
      path = os.path.join(root, name)
      rel = os.path.relpath(path, model_dir)
      files[rel] = {
          'sha256': _sha256(path),
          'bytes': os.path.getsize(path),
      }
  if not files:
    raise ValueError(f'No files under {model_dir}')
  return {
      'format': _FORMAT,
      'name': os.path.basename(os.path.normpath(model_dir)),
      'files': files,
  }


def pack(model_dir: str, archive_path: str) -> Dict:
  """Zips a model directory with an embedded manifest; returns it."""
  manifest = build_manifest(model_dir)
  with zipfile.ZipFile(
      archive_path, 'w', compression=zipfile.ZIP_DEFLATED
  ) as zf:
    zf.writestr(MANIFEST_NAME, json.dumps(manifest, indent=2, sort_keys=True))
    for rel in manifest['files']:
      zf.write(os.path.join(model_dir, rel), rel)
  return manifest


def unpack(archive_path: str, target_dir: str, verify: bool = True) -> str:
  """Extracts an artifact under target_dir/<name>; verifies the manifest.

  Returns the extracted model directory. Raises ValueError on a missing
  or mismatched manifest entry (corrupt or tampered archive).
  """
  with zipfile.ZipFile(archive_path) as zf:
    try:
      manifest = json.loads(zf.read(MANIFEST_NAME))
    except KeyError as e:
      raise ValueError(
          f'{archive_path} has no {MANIFEST_NAME}; not a '
          f'{_FORMAT} archive'
      ) from e
    if manifest.get('format') != _FORMAT:
      raise ValueError(
          f"Unknown artifact format {manifest.get('format')!r}"
      )
    out_dir = os.path.join(target_dir, manifest['name'])
    os.makedirs(out_dir, exist_ok=True)
    names = set(zf.namelist()) - {MANIFEST_NAME}
    missing = set(manifest['files']) - names
    if missing:
      raise ValueError(f'Archive is missing manifest entries: {missing}')
    out_abs = os.path.abspath(out_dir)
    for rel, meta in manifest['files'].items():
      # Zip entries may use '/' separators; normalize + confine to out_dir.
      dest = os.path.abspath(os.path.normpath(os.path.join(out_dir, rel)))
      if not dest.startswith(out_abs + os.sep):
        raise ValueError(f'Unsafe path in archive: {rel}')
      os.makedirs(os.path.dirname(dest), exist_ok=True)
      with zf.open(rel) as src, open(dest, 'wb') as dst:
        dst.write(src.read())
      if verify:
        got = _sha256(dest)
        if got != meta['sha256']:
          raise ValueError(
              f'Hash mismatch for {rel}: manifest {meta["sha256"]}, '
              f'file {got}'
          )
  return out_dir


def resolve_artifact(
    uri: str, cache_dir: str = '', refresh: bool = False
) -> str:
  """Resolves an artifact URI to a local model directory.

  Supported forms:
    * a local model DIRECTORY — returned as-is;
    * a local .zip bundle or file://<path>.zip — unpacked (once) into the
      cache and the extracted model dir returned;
    * gs://bucket/path.zip or http(s)://... — downloaded into the cache
      then unpacked. gs:// resolves through the public GCS HTTP endpoint
      (no gcloud dependency). In a zero-egress environment the download
      fails with a message naming the offline path (copy the bundle in,
      then pass its local path).

  Re-resolution is cheap: extractions are keyed by the archive's
  identity (path + size + mtime), so a re-packed local bundle at the
  same path re-extracts automatically. Remote downloads are keyed by
  URI and treated as immutable; pass refresh=True to force a
  re-download when the remote bundle has changed.
  """
  import urllib.parse
  import urllib.request

  if os.path.isdir(uri):
    return uri
  cache_dir = cache_dir or os.path.join(
      os.path.expanduser('~'), '.cache', 'putting_dune_torch', 'artifacts'
  )
  parsed = urllib.parse.urlparse(uri)
  scheme = parsed.scheme

  if scheme in ('', 'file'):
    archive = parsed.path if scheme == 'file' else uri
    if not os.path.exists(archive):
      raise FileNotFoundError(f'No artifact at {archive!r}')
  elif scheme in ('gs', 'http', 'https'):
    if scheme == 'gs':
      url = (
          'https://storage.googleapis.com/'
          f'{parsed.netloc}{parsed.path}'
      )
    else:
      url = uri
    os.makedirs(cache_dir, exist_ok=True)
    key = hashlib.sha256(uri.encode()).hexdigest()[:16]
    archive = os.path.join(
        cache_dir, f'{key}-{os.path.basename(parsed.path)}'
    )
    if refresh and os.path.exists(archive):
      os.remove(archive)
    if not os.path.exists(archive):
      # Download to a per-process temp name so concurrent resolvers of the
      # same URI cannot interleave writes; os.replace publishes atomically
      # (last writer wins with a complete file either way).
      tmp = f'{archive}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}'
      try:
        urllib.request.urlretrieve(url, tmp)
      except Exception as e:
        # Private gs:// buckets 403/404 through the anonymous endpoint:
        # fall back to the authenticated download.
        auth_ok, auth_err = False, None
        if scheme == 'gs':
          try:
            gcs.download(parsed.netloc, parsed.path.lstrip('/'), tmp)
            auth_ok = True
          except Exception as ae:  # auth/permission/transport failures
            auth_err = ae
        if not auth_ok:
          if os.path.exists(tmp):
            os.remove(tmp)
          detail = f'anonymous: {e}'
          if auth_err is not None:
            detail += f'; authenticated client: {auth_err}'
          raise RuntimeError(
              f'Could not download {uri!r} ({detail}). For private '
              'buckets, pip install google-cloud-storage and '
              'authenticate (GOOGLE_APPLICATION_CREDENTIALS). In a '
              'zero-egress environment, transfer the bundle by hand and '
              'pass its local path (integrity is checked by the embedded '
              'sha256 manifest, not the channel).'
          ) from e
      os.replace(tmp, archive)
  else:
    raise ValueError(
        f'Unsupported artifact URI scheme {scheme!r} in {uri!r}; expected '
        'a local dir/zip, file://, gs://, or http(s)://.'
    )

  # Key the extraction by the archive's content identity (path + size +
  # mtime), not its path alone: a re-packed bundle at the same path must
  # not resolve to the stale extraction.
  st = os.stat(archive)
  extract_key = (
      f'{os.path.abspath(archive)}:{st.st_size}:{st.st_mtime_ns}'
  )
  extract_root = os.path.join(
      cache_dir, hashlib.sha256(extract_key.encode()).hexdigest()[:16]
  )
  with zipfile.ZipFile(archive) as zf:
    name = json.loads(zf.read(MANIFEST_NAME))['name']
  model_dir = os.path.join(extract_root, name)
  # A cached extraction counts only if the completion marker exists: a
  # crashed or hash-rejected unpack leaves files but no marker, so it is
  # re-extracted instead of served as a (partial) model forever.
  done_marker = os.path.join(extract_root, '.complete')
  if os.path.isdir(model_dir) and os.path.exists(done_marker):
    return model_dir
  # Unpack into a per-process staging dir, mark it complete, then publish
  # atomically; a concurrent winner is served instead of clobbered.
  tmp_root = f'{extract_root}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}'
  try:
    unpack(archive, tmp_root)
    with open(os.path.join(tmp_root, '.complete'), 'w') as f:
      f.write(extract_key)
    # Publish under an O_EXCL lockfile so only one process ever holds the
    # rmtree+rename window: a COMPLETE extraction published by a concurrent
    # process must be served, never deleted — its caller may already be
    # reading files out of it. Only an incomplete residue (crashed unpack:
    # files but no marker) is cleared to make room for the rename.
    lock_path = f'{extract_root}.lock'
    deadline = time.monotonic() + 120.0
    while True:
      try:
        lock_fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        break
      except FileExistsError:
        if os.path.isdir(model_dir) and os.path.exists(done_marker):
          return model_dir  # a concurrent publisher finished first
        if time.monotonic() > deadline:
          # Stale lock from a crashed publisher: break it and retry.
          try:
            os.unlink(lock_path)
          except FileNotFoundError:
            pass
          deadline = time.monotonic() + 120.0
        time.sleep(0.05)
    try:
      if os.path.exists(done_marker):
        return model_dir
      shutil.rmtree(extract_root, ignore_errors=True)
      os.rename(tmp_root, extract_root)
    finally:
      os.close(lock_fd)
      try:
        os.unlink(lock_path)
      except FileNotFoundError:
        pass
  finally:
    shutil.rmtree(tmp_root, ignore_errors=True)
  return model_dir


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  sub = parser.add_subparsers(dest='cmd', required=True)
  p_pack = sub.add_parser('pack')
  p_pack.add_argument('--model_dir', required=True)
  p_pack.add_argument('--archive', required=True)
  p_unpack = sub.add_parser('unpack')
  p_unpack.add_argument('--archive', required=True)
  p_unpack.add_argument('--target_dir', required=True)
  p_unpack.add_argument(
      '--verify', action=argparse.BooleanOptionalAction, default=True
  )
  p_fetch = sub.add_parser(
      'fetch', help='Resolve a URI (dir / zip / file:// / gs:// / '
      'http(s)://) to a local model dir.'
  )
  p_fetch.add_argument('--uri', required=True)
  p_fetch.add_argument('--cache_dir', default='')
  args = parser.parse_args(argv)
  if args.cmd == 'pack':
    manifest = pack(args.model_dir, args.archive)
    print(
        f"Packed {manifest['name']} ({len(manifest['files'])} files) "
        f'-> {args.archive}'
    )
  elif args.cmd == 'fetch':
    print(resolve_artifact(args.uri, cache_dir=args.cache_dir))
  else:
    out = unpack(args.archive, args.target_dir, verify=args.verify)
    print(f'Unpacked -> {out}')


if __name__ == '__main__':
  main()
