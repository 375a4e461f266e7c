"""PyTorch port: remote corpus acquisition (`basic_pitch_torch/data/fetch.py`),
the cases of `tests/test_fetch.py` against a mocked HTTP remote on
localhost (Range resume, a server that ignores Range, checksum mismatch,
refetch no-op, retries, manual datasets, archive traversal), plus the
fetched tree and the traversal refusal held against the JAX package's
`fetch` (`tests/test_torch_params.py` pins `CATALOG` equal to JAX's).
Nothing here reaches the network."""

import dataclasses
import hashlib
import http.server
import io
import json
import threading
import wave
import zipfile

import numpy as np
import pytest

from basic_pitch_torch.data import commandline, fetch
from basic_pitch_torch.data.datasets import guitarset
from basic_pitch_tpu.data import fetch as j_fetch


# ---------------------------------------------------------------------------
# mocked remote: a threaded HTTP server with Range support
# ---------------------------------------------------------------------------


class _RangeHandler(http.server.BaseHTTPRequestHandler):
    files: dict = {}
    range_requests: list = []
    honor_range = True

    def do_GET(self):
        body = self.files.get(self.path)
        if body is None:
            self.send_error(404)
            return
        range_header = self.headers.get("Range")
        if range_header and self.honor_range:
            self.range_requests.append(range_header)
            start = int(range_header.split("=")[1].rstrip("-"))
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {start}-{len(body)-1}/{len(body)}")
            body = body[start:]
        else:
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture()
def remote():
    _RangeHandler.files = {}
    _RangeHandler.range_requests = []
    _RangeHandler.honor_range = True
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, _RangeHandler
    server.shutdown()
    thread.join(timeout=5)


def _url(server, path):
    return f"http://127.0.0.1:{server.server_address[1]}{path}"


def _tiny_guitarset_zip_pair():
    """(annotation.zip bytes, audio zip bytes) for a one-track corpus."""
    sr = 22050
    t = np.arange(sr) / sr
    pcm = (np.sin(2 * np.pi * 220.0 * t) * 0.4 * 32767).astype("<i2")
    wav_buf = io.BytesIO()
    with wave.open(wav_buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(pcm.tobytes())

    jam = {
        "annotations": [
            {
                "namespace": "note_midi",
                "data": [{"time": 0.1, "duration": 0.5, "value": 57.0, "confidence": None}],
            },
            {
                "namespace": "pitch_contour",
                "data": [
                    {"time": 0.1, "duration": 0.0, "value": {"frequency": 220.0, "index": 0, "voiced": True}}
                ],
            },
        ]
    }
    ann_buf = io.BytesIO()
    with zipfile.ZipFile(ann_buf, "w") as zf:
        zf.writestr("00_Rock1.jams", json.dumps(jam))
    audio_buf = io.BytesIO()
    with zipfile.ZipFile(audio_buf, "w") as zf:
        zf.writestr("00_Rock1_mic.wav", wav_buf.getvalue())
    return ann_buf.getvalue(), audio_buf.getvalue()


def _remotes_for(server, ann, audio, with_checksums=True):
    def md5(b):
        return hashlib.md5(b).hexdigest() if with_checksums else None

    return (
        fetch.RemoteFile(
            filename="annotation.zip",
            url=_url(server, "/annotation.zip"),
            checksum=md5(ann),
            destination_dir="annotation",
        ),
        fetch.RemoteFile(
            filename="audio_mono-mic.zip",
            url=_url(server, "/audio_mono-mic.zip"),
            checksum=md5(audio),
            destination_dir="audio_mono-mic",
        ),
    )


# ---------------------------------------------------------------------------


def test_empty_dir_to_tfrecord_shards(remote, tmp_path):
    """The full reference workflow: empty --source, --fetch downloads and
    unpacks the corpus, and the builder writes TFRecord shards."""
    server, handler = remote
    ann, audio = _tiny_guitarset_zip_pair()
    handler.files["/annotation.zip"] = ann
    handler.files["/audio_mono-mic.zip"] = audio
    source = tmp_path / "corpus"

    fetch.fetch_dataset("guitarset", source, remotes=_remotes_for(server, ann, audio))
    assert (source / "annotation" / "00_Rock1.jams").is_file()
    assert (source / "audio_mono-mic" / "00_Rock1_mic.wav").is_file()

    # build straight from the fetched corpus through the real CLI surface
    dest = tmp_path / "out"
    args = guitarset.build_parser().parse_args(
        ["--source", str(source), "--destination", str(dest), "--timestamped", "false"]
    )
    guitarset.main(args)
    shards = list(dest.rglob("*.tfrecord"))
    assert shards, "no TFRecord shards written"


def test_resume_uses_range_request(remote, tmp_path):
    server, handler = remote
    payload = bytes(range(256)) * 1000
    handler.files["/blob.bin"] = payload
    remote_file = fetch.RemoteFile(
        filename="blob.bin",
        url=_url(server, "/blob.bin"),
        checksum=hashlib.md5(payload).hexdigest(),
    )
    downloads = tmp_path / "_downloads"
    downloads.mkdir()
    (downloads / "blob.bin.part").write_bytes(payload[:5000])  # interrupted run

    local = fetch.fetch_file(remote_file, tmp_path)
    assert handler.range_requests == ["bytes=5000-"]
    assert local.read_bytes() == payload


def test_resume_restarts_when_server_ignores_range(remote, tmp_path):
    server, handler = remote
    handler.honor_range = False
    payload = b"x" * 10000
    handler.files["/blob.bin"] = payload
    remote_file = fetch.RemoteFile(
        filename="blob.bin",
        url=_url(server, "/blob.bin"),
        checksum=hashlib.md5(payload).hexdigest(),
    )
    downloads = tmp_path / "_downloads"
    downloads.mkdir()
    (downloads / "blob.bin.part").write_bytes(b"y" * 123)  # stale partial

    local = fetch.fetch_file(remote_file, tmp_path)
    assert local.read_bytes() == payload  # restarted clean, not appended


def test_checksum_mismatch_removes_file(remote, tmp_path):
    server, handler = remote
    handler.files["/bad.bin"] = b"corrupted-by-mirror"
    remote_file = fetch.RemoteFile(
        filename="bad.bin", url=_url(server, "/bad.bin"), checksum="0" * 32
    )
    with pytest.raises(fetch.IntegrityError):
        fetch.fetch_file(remote_file, tmp_path, retries=1)
    assert not (tmp_path / "_downloads" / "bad.bin").exists()


def test_refetch_is_noop(remote, tmp_path):
    server, handler = remote
    ann, audio = _tiny_guitarset_zip_pair()
    handler.files["/annotation.zip"] = ann
    handler.files["/audio_mono-mic.zip"] = audio
    remotes = _remotes_for(server, ann, audio)

    fetch.fetch_dataset("guitarset", tmp_path, remotes=remotes)
    handler.files.clear()  # remote goes dark; cached artifacts must suffice
    fetch.fetch_dataset("guitarset", tmp_path, remotes=remotes)


def test_download_failure_raises_after_retries(remote, tmp_path):
    server, handler = remote  # no files registered -> 404
    remote_file = fetch.RemoteFile(filename="gone.bin", url=_url(server, "/gone.bin"))
    with pytest.raises(fetch.FetchError):
        fetch.fetch_file(remote_file, tmp_path, retries=2)


def test_manual_download_datasets_raise_with_instructions(tmp_path):
    with pytest.raises(fetch.ManualDownloadRequired, match="iKala"):
        fetch.fetch_dataset("ikala", tmp_path)
    with pytest.raises(fetch.ManualDownloadRequired, match="MedleyDB"):
        fetch.fetch_dataset("medleydb_pitch", tmp_path)


def test_archive_traversal_refused(tmp_path):
    evil = tmp_path / "evil.zip"
    with zipfile.ZipFile(evil, "w") as zf:
        zf.writestr("../escape.txt", "nope")
    with pytest.raises(fetch.FetchError, match="escapes"):
        fetch.extract_archive(evil, tmp_path / "dest")


def test_catalog_covers_all_builders():
    assert set(fetch.CATALOG) == {"guitarset", "maestro", "slakh", "ikala", "medleydb_pitch"}


def test_fetch_flag_surfaced_on_parsers():
    args = guitarset.build_parser().parse_args(["--source", "/tmp/x", "--fetch"])
    assert args.fetch is True
    # maybe_fetch is a no-op without the flag
    args2 = guitarset.build_parser().parse_args(["--source", "/tmp/x"])
    commandline.maybe_fetch(args2, "guitarset")


def test_fetched_tree_equals_jax(remote, tmp_path):
    """Both fetchers against the same remote leave the same files behind
    (downloads, unpacked corpus, markers)."""
    server, handler = remote
    ann, audio = _tiny_guitarset_zip_pair()
    handler.files["/annotation.zip"] = ann
    handler.files["/audio_mono-mic.zip"] = audio
    trees = []
    for module, name in ((fetch, "torch"), (j_fetch, "jax")):
        remotes = [module.RemoteFile(**dataclasses.asdict(r)) for r in _remotes_for(server, ann, audio)]
        root = module.fetch_dataset("guitarset", tmp_path / name, remotes=remotes)
        trees.append({p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()})
    assert trees[0] == trees[1]
    assert "_downloads/annotation.zip.unpacked" in trees[0]


@pytest.mark.parametrize("archive", ["zip", "tar.gz"])
def test_archive_traversal_refused_like_jax(tmp_path, archive):
    evil = tmp_path / f"evil.{archive}"
    if archive == "zip":
        with zipfile.ZipFile(evil, "w") as zf:
            zf.writestr("ok.txt", "fine")
            zf.writestr("sub/../../escape.txt", "nope")
    else:
        import tarfile

        with tarfile.open(evil, "w:gz") as tf:
            member = tarfile.TarInfo("../escape.txt")
            member.size = 4
            tf.addfile(member, io.BytesIO(b"nope"))
    for module in (fetch, j_fetch):
        with pytest.raises(module.FetchError, match="escapes"):
            module.extract_archive(evil, tmp_path / "dest")
    assert not (tmp_path / "escape.txt").exists()
