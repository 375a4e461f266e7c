"""PyTorch/CUDA port of basic_pitch_tpu: audio to posteriorgrams to note
events on an NVIDIA GPU.

The port imports nothing of the JAX package. Its entry point is
`basic_pitch_torch.pipeline.StreamingTranscriber`, which runs on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
