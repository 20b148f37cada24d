"""Command lines of the port, the counterparts of the repository's
scripts/{serve,extract_pdf,extract_page,ingest_to_index,qa_query,
eval_retrieval,train_vlm,train_embedder}.py, with their arguments, stdout
lines and output files. Run each as

    python -m vision_compression_project_tpu_torch.scripts.<name> --help

The device is RUNTIME.device (VCP_DEVICE, the card unless it says "cpu")."""

import logging


def configure_logging() -> None:
    """INFO logs on stderr, in the format of the JAX package's command lines."""
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
