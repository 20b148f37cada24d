"""The port's multi-device dry run (vision_compression_project_tpu_torch/
dryrun.py), the counterpart of `__graft_entry__.py`, on gloo ranks.

- `dryrun_multichip(4)`: the whole train step of `tiny_moe` at (data 1,
  seq 1, expert 2, model 2) and (data 1, seq 2, expert 2, model 1), the
  losses agreeing, then the pipelined step at data 2 x model 2: the
  reference's lines, with seq, expert, model and pipeline(model) above one
  rank in the matrix and data in the pipelined step. The losses are not the
  JAX package's: the port seeds its weights in its own way.
- `python -m vision_compression_project_tpu_torch.dryrun 2` as a command.
- `_mesh_matrix` equals the reference's for 8, 4, 2 and 1 devices.
- `entry()` on the CPU: the logits of `base` on the reference's example
  arguments.
"""

import ast
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vision_compression_project_tpu_torch import dryrun

REPO = Path(__file__).resolve().parents[1]
MESH_LINE = re.compile(r"^dryrun mesh=(\{.*\}) loss=(\d+\.\d{4}) step=1$")
PP_LINE = re.compile(r"^dryrun PP mesh=(\{.*\}) loss=(\d+\.\d{4})$")


def test_dryrun_multichip_on_four_gloo_ranks():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = dryrun.dryrun_multichip(4, "cpu")
    assert buf.getvalue().splitlines() == lines and len(lines) == 4
    shapes = [ast.literal_eval(MESH_LINE.match(line).group(1)) for line in lines[:2]]
    assert shapes == [{"data": 1, "seq": 1, "expert": 2, "model": 2}, {"data": 1, "seq": 2, "expert": 2, "model": 1}]
    losses = [float(MESH_LINE.match(line).group(2)) for line in lines[:2]]
    assert abs(losses[0] - losses[1]) <= 5e-2 * max(1.0, losses[0])
    pp = PP_LINE.match(lines[2])
    assert ast.literal_eval(pp.group(1)) == {"data": 2, "seq": 1, "expert": 1, "model": 2}
    assert 0.0 < float(pp.group(2)) < 20.0
    assert lines[3] == "dryrun_multichip OK: n=4 meshes=2 axes>1=['expert', 'model', 'pipeline(model)', 'seq']"


def test_dryrun_command_line_on_two_ranks(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "vision_compression_project_tpu_torch.dryrun", "2"], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert [ast.literal_eval(MESH_LINE.match(line).group(1)) for line in lines[:2]] == [
        {"data": 1, "seq": 1, "expert": 1, "model": 2}, {"data": 1, "seq": 2, "expert": 1, "model": 1}]
    assert ast.literal_eval(PP_LINE.match(lines[2]).group(1)) == {"data": 1, "seq": 1, "expert": 1, "model": 2}
    assert lines[3] == "dryrun_multichip OK: n=2 meshes=2 axes>1=['model', 'pipeline(model)', 'seq']"


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_mesh_matrix_is_the_reference_s(n):
    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__
    finally:
        sys.path.remove(str(REPO))
    want = [(m.data, m.seq, m.expert, m.model) for m in __graft_entry__._mesh_matrix(n)]
    assert [m.shape for m in dryrun._mesh_matrix(n)] == want


def test_entry_runs_on_the_cpu():
    fn, args = dryrun.entry("cpu")
    cfg = dryrun.get_preset("base")
    params, pages, ids = args
    assert pages.shape == (2, cfg.vision.grid ** 2, cfg.vision.patch ** 2 * 3) and ids.shape == (2, 128)
    logits = fn(*args)
    assert logits.shape == (2, cfg.vision.tokens_out + 128, cfg.decoder.vocab)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    # The params argument is what the forward reads: other weights, other logits.
    other = {k: (v * 0.5 if k == "decoder.unembed.weight" else v) for k, v in params.items()}
    assert not torch.equal(fn(other, pages, ids), logits)
