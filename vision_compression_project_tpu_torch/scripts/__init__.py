"""Command lines of the port, the counterparts of the repository's
scripts/{serve,extract_pdf,extract_page,ingest_to_index,qa_query,
eval_retrieval,train_vlm,train_embedder,eval_extract,eval_ocr,train_answer,
eval_answer,ship_checkpoint,run_answer_hop,export_stage_params,
run_curriculum,train_bpe}.py, with their arguments, stdout lines and output files.
The drivers (run_answer_hop, run_curriculum) run the others as
`python -m vision_compression_project_tpu_torch.scripts.<name>`;
ship_checkpoint writes under checkpoints/torch/ by default and refuses
checkpoints/default/. Run each as

    python -m vision_compression_project_tpu_torch.scripts.<name> --help

The device is RUNTIME.device (VCP_DEVICE, the card unless it says "cpu")."""

import logging
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def configure_logging() -> None:
    """INFO logs on stderr, in the format of the JAX package's command lines."""
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")


def run_step(cmd, log_path, dry: bool = False) -> int:
    """A driver's step: the port's command line cmd[0] with arguments
    cmd[1:], run from the repository root as `python -m <package>.<name>`
    with its output appended to log_path; the command is printed first, and
    with `dry` nothing runs. Returns the exit code (0 when dry)."""
    args = ["-m", f"{__name__}.{cmd[0]}", *map(str, cmd[1:])]
    print("+", " ".join(args), flush=True)
    if dry:
        return 0
    with open(log_path, "ab") as log:
        return subprocess.run([sys.executable, *args], cwd=REPO, stdout=log, stderr=subprocess.STDOUT).returncode
