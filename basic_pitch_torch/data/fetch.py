"""Remote corpus acquisition for ``basic-pitch-torch-download --fetch``.

A copy of `basic_pitch_tpu/data/fetch.py`, the first-party equivalent of
the reference's mirdata acquisition step: a small stdlib HTTP fetcher with

- **resume**: interrupted downloads leave a ``.part`` file that the next run
  continues with an HTTP ``Range`` request (falling back to a restart when
  the server ignores ranges),
- **integrity**: md5 verification of every completed file when the catalog
  (or caller) supplies a checksum; mismatches delete the file and raise,
- **idempotence**: verified archives are kept under ``<data_home>/_downloads``
  and unpacks are marked, so a re-run of ``--fetch`` is a fast no-op,
- **safe extraction**: zip/tar members are validated against path traversal
  before unpacking.

Catalog entries carry the public distribution URLs. Hosts that require a
manual access request (iKala, MedleyDB) raise `ManualDownloadRequired` with
instructions instead. `tests/test_torch_params.py` pins `CATALOG` equal to
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import pathlib
import shutil
import tarfile
import time
import urllib.error
import urllib.request
import zipfile
from typing import Callable, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_CHUNK = 1 << 20  # 1 MiB streaming chunks


class FetchError(RuntimeError):
    """A remote file could not be downloaded after retries."""


class IntegrityError(FetchError):
    """A downloaded file failed checksum verification."""


class ManualDownloadRequired(FetchError):
    """The corpus host requires a manual access request; no fetchable URL."""


@dataclasses.dataclass(frozen=True)
class RemoteFile:
    """One remote artifact of a corpus.

    Attributes:
        filename: local name of the artifact under ``<data_home>/_downloads``.
        url: HTTP(S) source. Empty string for manual-download corpora.
        checksum: md5 hex digest to verify against, or None to skip
            verification (logged as unverified).
        destination_dir: directory relative to ``data_home`` that the archive
            unpacks into (or a plain file is placed into). "" = data_home.
        instructions: shown when ``url`` is empty (manual-download hosts).
    """

    filename: str
    url: str = ""
    checksum: Optional[str] = None
    destination_dir: str = ""
    instructions: str = ""

    @property
    def is_archive(self) -> bool:
        n = self.filename
        return n.endswith((".zip", ".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tar.xz"))


# ---------------------------------------------------------------------------
# Per-dataset catalogs. URLs are the public distribution locations the
# reference reaches through mirdata's indexes. Checksums are verified when
# present; entries without one are logged as unverified (upstream hosts
# rotate archives without stable sidecar digests).
# ---------------------------------------------------------------------------

CATALOG: dict[str, Tuple[RemoteFile, ...]] = {
    "guitarset": (
        RemoteFile(
            filename="annotation.zip",
            url="https://zenodo.org/record/3371780/files/annotation.zip",
            destination_dir="annotation",
        ),
        RemoteFile(
            filename="audio_mono-mic.zip",
            url="https://zenodo.org/record/3371780/files/audio_mono-mic.zip",
            destination_dir="audio_mono-mic",
        ),
    ),
    "maestro": (
        RemoteFile(
            filename="maestro-v2.0.0.zip",
            url="https://storage.googleapis.com/magentadata/datasets/maestro/v2.0.0/maestro-v2.0.0.zip",
            destination_dir="",
        ),
    ),
    "slakh": (
        RemoteFile(
            filename="slakh2100_flac_redux.tar.gz",
            url="https://zenodo.org/record/4599666/files/slakh2100_flac_redux.tar.gz",
            destination_dir="",
        ),
    ),
    "ikala": (
        RemoteFile(
            filename="iKala.zip",
            instructions=(
                "The iKala corpus is no longer publicly distributed; it was "
                "obtained via a signed agreement with CITI Academia Sinica. "
                "Place the corpus under --source manually (Wavfile/ and "
                "PitchLabel/ directories)."
            ),
        ),
    ),
    "medleydb_pitch": (
        RemoteFile(
            filename="MedleyDB-Pitch.zip",
            instructions=(
                "MedleyDB pitch tracking subset requires a data request via "
                "https://medleydb.weebly.com/downloads.html (hosted on Zenodo "
                "with access approval). Unpack it under --source manually "
                "(audio/ and annotation/ directories plus "
                "medleydb_pitch_metadata.json)."
            ),
        ),
    ),
}


def _md5(path: pathlib.Path) -> str:
    digest = hashlib.md5()
    with path.open("rb") as fh:
        while True:
            block = fh.read(_CHUNK)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest()


def _stream_to(response, out, progress: Optional[Callable[[int], None]] = None) -> None:
    while True:
        block = response.read(_CHUNK)
        if not block:
            return
        out.write(block)
        if progress is not None:
            progress(len(block))


def fetch_file(
    remote: RemoteFile,
    data_home: pathlib.Path,
    retries: int = 3,
    progress: Optional[Callable[[int], None]] = None,
    opener: Optional[Callable] = None,
) -> pathlib.Path:
    """Download one remote artifact with resume + verification.

    Returns the path of the verified local file under
    ``<data_home>/_downloads``. Raises `IntegrityError` on checksum mismatch
    (the corrupt file is removed) and `FetchError` when the transfer keeps
    failing. ``opener`` overrides ``urllib.request.urlopen`` (tests inject a
    mocked remote through it).
    """
    if not remote.url:
        raise ManualDownloadRequired(
            remote.instructions or f"{remote.filename} has no public download URL"
        )
    open_url = opener or urllib.request.urlopen

    downloads = pathlib.Path(data_home) / "_downloads"
    downloads.mkdir(parents=True, exist_ok=True)
    final = downloads / remote.filename
    part = downloads / (remote.filename + ".part")

    if final.exists():
        if remote.checksum is None or _md5(final) == remote.checksum:
            logger.info("%s: already downloaded", remote.filename)
            return final
        logger.warning("%s: cached file fails verification; re-downloading", remote.filename)
        final.unlink()

    last_error: Optional[Exception] = None
    for attempt in range(retries):
        if attempt:
            time.sleep(min(2.0**attempt, 30.0))
        try:
            offset = part.stat().st_size if part.exists() else 0
            request = urllib.request.Request(remote.url)
            if offset:
                request.add_header("Range", f"bytes={offset}-")
            with open_url(request) as response:
                status = getattr(response, "status", None) or response.getcode()
                if offset and status != 206:
                    # server ignored the range: restart from zero
                    logger.info("%s: server does not resume; restarting", remote.filename)
                    offset = 0
                mode = "ab" if offset else "wb"
                with part.open(mode) as out:
                    _stream_to(response, out, progress)
            part.rename(final)
            break
        except ManualDownloadRequired:
            raise
        except (urllib.error.URLError, OSError, ValueError) as exc:
            last_error = exc
            logger.warning(
                "%s: attempt %d/%d failed: %s", remote.filename, attempt + 1, retries, exc
            )
    else:
        raise FetchError(f"{remote.filename}: download failed after {retries} attempts") from last_error

    if remote.checksum is not None:
        actual = _md5(final)
        if actual != remote.checksum:
            final.unlink()
            raise IntegrityError(
                f"{remote.filename}: md5 mismatch (expected {remote.checksum}, got {actual})"
            )
    else:
        logger.warning("%s: no checksum in catalog; downloaded unverified", remote.filename)
    return final


def _safe_members(names: Sequence[str]) -> None:
    for name in names:
        p = pathlib.PurePosixPath(name)
        if p.is_absolute() or ".." in p.parts:
            raise FetchError(f"archive member escapes destination: {name!r}")


def extract_archive(archive: pathlib.Path, dest: pathlib.Path) -> None:
    """Unpack a zip/tar archive into ``dest``, refusing path traversal."""
    dest.mkdir(parents=True, exist_ok=True)
    if archive.name.endswith(".zip"):
        with zipfile.ZipFile(archive) as zf:
            _safe_members(zf.namelist())
            zf.extractall(dest)
        return
    with tarfile.open(archive) as tf:
        _safe_members(tf.getnames())
        try:
            tf.extractall(dest, filter="data")
        except TypeError:  # Python without the filter kwarg
            tf.extractall(dest)


def fetch_dataset(
    name: str,
    data_home: "str | pathlib.Path",
    remotes: Optional[Sequence[RemoteFile]] = None,
    retries: int = 3,
    progress: Optional[Callable[[int], None]] = None,
    opener: Optional[Callable] = None,
) -> pathlib.Path:
    """Fetch every remote artifact of ``name`` into ``data_home``.

    Archives unpack into ``data_home / destination_dir``; plain files are
    copied there. Completed unpacks are marked so re-runs skip both the
    transfer (verified archive cached) and the extraction.
    """
    if remotes is None:
        try:
            remotes = CATALOG[name]
        except KeyError:
            raise FetchError(f"no remote catalog for dataset {name!r}") from None
    data_home = pathlib.Path(data_home)
    data_home.mkdir(parents=True, exist_ok=True)

    for remote in remotes:
        local = fetch_file(remote, data_home, retries=retries, progress=progress, opener=opener)
        marker = local.with_name(local.name + ".unpacked")
        if marker.exists():
            logger.info("%s: already unpacked", remote.filename)
            continue
        dest = data_home / remote.destination_dir if remote.destination_dir else data_home
        if remote.is_archive:
            logger.info("%s: unpacking into %s", remote.filename, dest)
            extract_archive(local, dest)
        else:
            dest.mkdir(parents=True, exist_ok=True)
            shutil.copy2(local, dest / remote.filename)
        marker.touch()
    return data_home
