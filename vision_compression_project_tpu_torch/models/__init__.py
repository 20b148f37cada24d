from .configs import PRESETS, DecoderConfig, EmbedderConfig, VisionConfig, VLMConfig, get_preset
from .embedder import HashNGramEmbedder, NeuralEmbedder, get_embedder
from .tokenizer import BPETokenizer, ByteTokenizer, get_tokenizer
from .vlm import OpticalVLM, VLMRunner

__all__ = [
    "PRESETS", "DecoderConfig", "EmbedderConfig", "VisionConfig", "VLMConfig", "get_preset",
    "HashNGramEmbedder", "NeuralEmbedder", "get_embedder",
    "BPETokenizer", "ByteTokenizer", "get_tokenizer", "OpticalVLM", "VLMRunner",
]
