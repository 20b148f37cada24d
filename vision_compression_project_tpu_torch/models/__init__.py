from .configs import PRESETS, DecoderConfig, VisionConfig, VLMConfig, get_preset
from .tokenizer import BPETokenizer, ByteTokenizer, get_tokenizer
from .vlm import OpticalVLM, VLMRunner

__all__ = [
    "PRESETS", "DecoderConfig", "VisionConfig", "VLMConfig", "get_preset",
    "BPETokenizer", "ByteTokenizer", "get_tokenizer", "OpticalVLM", "VLMRunner",
]
