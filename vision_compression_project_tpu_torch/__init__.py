"""PyTorch + CUDA port of vision_compression_project_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only; nothing of JAX or of
the JAX package. Entry point: `VLMRunner(get_preset("ocr_real"),
device="cuda").extract_batch(pages_u8, page_numbers)`.
"""

from .models import PRESETS, VLMRunner, get_preset

__all__ = ["PRESETS", "VLMRunner", "get_preset"]
