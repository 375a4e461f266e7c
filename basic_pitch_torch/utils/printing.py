"""CLI output helpers (emoji confirmations and failure messages).

A copy of `basic_pitch_tpu/utils/printing.py` (the port imports nothing of
the JAX package); `tests/test_torch_params.py` pins the output equal.
"""

from __future__ import annotations

import contextlib
import pathlib
from typing import Iterator, Union

OUTPUT_EMOJIS = {
    "MIDI": "💅",
    "MODEL_OUTPUT_NPZ": "💁‍♀️",
    "MIDI_SONIFICATION": "🎧",
    "NOTE_EVENTS": "🌸",
}


def generating_file_message(output_type: str) -> None:
    print(f"\n\n  Creating {output_type.replace('_', ' ').lower()}...")


def file_saved_confirmation(output_type: str, save_path: Union[pathlib.Path, str]) -> None:
    print(f"  {OUTPUT_EMOJIS.get(output_type, '✨')} Saved to {save_path}")


def failed_to_save(output_type: str, save_path: Union[pathlib.Path, str]) -> None:
    print(f"  🚨 Failed to save {output_type.replace('_', ' ').lower()} to {save_path}")


@contextlib.contextmanager
def no_warnings() -> Iterator[None]:
    """Suppress noisy backend warnings for clean CLI output."""
    import logging

    logger = logging.getLogger()
    previous = logger.level
    logger.setLevel(logging.ERROR)
    try:
        yield
    finally:
        logger.setLevel(previous)
