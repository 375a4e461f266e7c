"""The piece upload that the transcribers share: host rows of PCM to a
device, raw or through the lossless codec.

One pinned host buffer is refilled per piece and copied on a side stream of
the target device, so the next piece's upload overlaps the compute queued
behind the current one; the compute stream waits for the copy's event. A
piece whose codec wire is smaller than its raw bytes goes as the wire and
is rebuilt on the device by `pcmcodec.decode_wire`; any other piece goes
raw (the JAX package's rule). The codec packs on host worker threads
(`transport.PACK_WORKERS`), made at the first codec dispatch.
"""

from __future__ import annotations

import concurrent.futures
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from basic_pitch_torch.ops import pcmcodec
from basic_pitch_torch.ops import transport


def padded_slice(x: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """x[lo:hi] with zero padding for out-of-range indices (a view when
    the slice is interior)."""
    if 0 <= lo and hi <= len(x):
        return x[lo:hi]
    out = np.zeros(hi - lo, dtype=x.dtype)
    src_lo, src_hi = max(lo, 0), min(hi, len(x))
    if src_hi > src_lo:
        out[src_lo - lo : src_hi - lo] = x[src_lo:src_hi]
    return out


def pack_wire(piece: np.ndarray) -> "Tuple[pcmcodec.PackedPCM, Tuple[np.ndarray, pcmcodec.WireLayout]]":
    """Pack one int16 piece and lay out its wire (on a packer thread)."""
    packed = pcmcodec.pack(piece)
    return packed, pcmcodec.to_wire(packed)


def use_codec(mode: str, dtype: np.dtype, device: torch.device) -> bool:
    """Should int16 rows for ``device`` ride the codec under ``mode``?
    "codec" and "raw" are unconditional; "auto" follows the cached probe of
    that device and never starts a measurement. Float input goes raw."""
    if dtype != np.int16 or mode == "raw":
        return False
    if mode == "codec":
        return True
    return transport.resolve("auto", device=device) == "codec"


class PieceUploader:
    """Ships host arrays to devices through one pinned buffer, counting the
    bytes that crossed per key in ``piece_upload_bytes``."""

    def __init__(self, devices: Iterable[torch.device]):
        self.piece_upload_bytes: Dict[str, int] = {}
        self._pinned: Optional[torch.Tensor] = None
        self._upload_done: Optional[torch.cuda.Event] = None
        self._copy_streams = {dev: torch.cuda.Stream(dev) for dev in devices if dev.type == "cuda"}
        self._pack_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None

    def close(self) -> None:
        """Wait for the last copy, release the pinned buffer and the packer
        threads (idempotent; a later upload makes them again)."""
        if self._upload_done is not None:
            self._upload_done.synchronize()
        self._pinned = None
        self._upload_done = None
        if self._pack_pool is not None:
            self._pack_pool.shutdown(wait=True)
            self._pack_pool = None

    def packer_threads(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._pack_pool is None:
            self._pack_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=transport.PACK_WORKERS, thread_name_prefix="bp-pack"
            )
        return self._pack_pool

    def upload(self, piece: np.ndarray, device: torch.device) -> torch.Tensor:
        """Ship one host array (a float32 or int16 row, or a codec wire of
        uint8) to ``device`` through the pinned buffer; the buffer is
        rewritten only after the previous copy from it has landed."""
        if device.type == "cpu":
            return torch.from_numpy(np.array(piece))
        dtype = torch.from_numpy(piece[:0]).dtype
        if self._upload_done is not None:
            self._upload_done.synchronize()  # the pinned buffer is free again
        if self._pinned is None or self._pinned.numel() < piece.nbytes:
            self._pinned = torch.empty(piece.nbytes, dtype=torch.uint8, pin_memory=True)
        host = self._pinned[: piece.nbytes].view(dtype)
        host.numpy()[:] = piece
        compute = torch.cuda.current_stream(device)
        copy_stream = self._copy_streams[device]
        with torch.cuda.stream(copy_stream):
            dev = host.to(device, non_blocking=True)
            self._upload_done = torch.cuda.Event()
            self._upload_done.record(copy_stream)
        compute.wait_event(self._upload_done)
        dev.record_stream(compute)
        return dev

    def upload_piece(
        self,
        piece: np.ndarray,
        packed: "Optional[Tuple[pcmcodec.PackedPCM, Tuple[np.ndarray, pcmcodec.WireLayout]]]",
        device: torch.device,
        key: str,
    ) -> torch.Tensor:
        """One row on ``device`` as float32 samples, counting the bytes that
        crossed under ``key``: the codec's packed bytes where they are fewer
        than the raw row's (one `pcm_decode` launch on that device), else the
        raw row."""
        if packed is not None and packed[0].packed_bytes < piece.nbytes:
            pk, (wire, layout) = packed
            self.piece_upload_bytes[key] = self.piece_upload_bytes.get(key, 0) + pk.packed_bytes
            return pcmcodec.decode_wire(self.upload(wire, device), layout, len(piece))
        # an incompressible piece goes raw: strictly fewer bytes (JAX's rule)
        self.piece_upload_bytes[key] = self.piece_upload_bytes.get(key, 0) + piece.nbytes
        x = self.upload(piece, device)
        return x.to(torch.float32) * (1.0 / 32768.0) if x.dtype == torch.int16 else x
