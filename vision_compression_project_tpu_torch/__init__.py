"""PyTorch + CUDA port of vision_compression_project_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only; nothing of JAX or of
the JAX package. Entry points: `pipeline.extract.extract_pdf_to_page_jsons`
(/ingest from a PDF), `pipeline.qa.answer_question` (/chat) and
`VLMRunner(get_preset("ocr_real"), device="cuda").extract_batch(pages_u8,
page_numbers)`; `train.checkpoint.load_runner` loads the shipped weights.
"""

from .models import PRESETS, VLMRunner, get_preset

__all__ = ["PRESETS", "VLMRunner", "get_preset"]
