"""The port's drivers and publishing command lines against the repository's
own, on the CPU:

- run_curriculum --dry_run prints the JAX script's command plan, with each
  `scripts/<name>.py` as `-m vision_compression_project_tpu_torch.scripts.<name>`,
  from a fresh start and from a resumed state (a stage with its own
  checkpoint and a train.done marker);
- run_answer_hop with `_run` replaced, in both packages, by a stub that
  writes fixed eval JSONs gives the JAX script's answer_hop.json (states,
  evals and gate keys) and gate record, for a passing gate, a failing gate
  and a failed training run; the port's ship goes to --ship_root;
- ship_checkpoint writes a params-only checkpoint that load_runner reads
  back with equal parameters, the JAX script's meta.json and gate files (its
  save step stubbed into a temporary root), removes a stale ship, and
  refuses checkpoints/default/;
- export_stage_params exports a fake curriculum's newest stage once.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from vision_compression_project_tpu import config as jconfig
from vision_compression_project_tpu.train import checkpoint as jcheckpoint
from vision_compression_project_tpu_torch import config as tconfig
from vision_compression_project_tpu_torch.models import get_preset
from vision_compression_project_tpu_torch.scripts import export_stage_params as texport
from vision_compression_project_tpu_torch.scripts import run_answer_hop as thop
from vision_compression_project_tpu_torch.scripts import run_curriculum as tcurr
from vision_compression_project_tpu_torch.scripts import ship_checkpoint as tship
from vision_compression_project_tpu_torch.train import checkpoint as tcheckpoint
from vision_compression_project_tpu_torch.train.train_step import make_train_state

from torch_parity import jax_script

PORT = "-m vision_compression_project_tpu_torch.scripts."


def _as_port(line: str) -> str:
    """A JAX driver's command line as the port prints it."""
    if line.startswith("+ scripts/"):
        name, rest = line[len("+ scripts/"):].split(".py", 1)
        return f"+ {PORT}{name}{rest}"
    return line


@pytest.mark.parametrize("resume", [False, True], ids=["fresh", "resume"])
def test_run_curriculum_dry_run_plan_equals_jax(tmp_path, capsys, monkeypatch, resume):
    out = tmp_path / "curr"

    def prepare():
        if resume:
            (out / "mixC_e1" / "step_00000500").mkdir(parents=True, exist_ok=True)
            (out / "mixC_e1" / "train.done").touch()
            (out / "readB_e0" / "step_00000500").mkdir(parents=True, exist_ok=True)
            state = {"stage": 4, "extension": 0, "init_from": str(out / "readA_e2"), "history": []}
            (out / "curriculum.json").write_text(json.dumps(state))

    args = ["--out", str(out), "--dry_run", "--init_from", "checkpoints/default/ocr_real", "--seed", "3",
            *(["--resume"] if resume else [])]
    prepare()
    tcurr.main(args)
    got = capsys.readouterr().out.splitlines()
    prepare()
    monkeypatch.setattr(sys, "argv", ["run_curriculum.py", *args])
    jax_script("run_curriculum").main()
    want = capsys.readouterr().out.splitlines()
    assert got == [_as_port(line) for line in want]
    assert sum(line.startswith("+ ") for line in got) == (7 if resume else 11)  # trainings and ships
    assert tcurr.DEFAULT_STAGES == jax_script("run_curriculum").DEFAULT_STAGES


PASS = {"agg_real": {"task": "agg", "lm_keyfact_accuracy": 0.5, "extractive_keyfact_accuracy": 0.25},
        "imitate_real": {"task": "imitate", "similarity_mean": 0.61},
        "imitate_words": {"task": "imitate", "similarity_mean": 0.7},
        "extract": {"markdown_similarity_mean": 0.45}}
FAIL = dict(PASS, agg_real={"task": "agg", "lm_keyfact_accuracy": 0.1, "extractive_keyfact_accuracy": 0.25},
            extract={"markdown_similarity_mean": 0.2})


def _stub_run(evals, calls, train_rc=0):
    """A driver's `_run`: records the command line's name and arguments,
    writes the fixed eval JSON a --json_out asks for, and returns train_rc
    for the training run, 0 otherwise."""
    def run(cmd, log_path):
        name = Path(str(cmd[0])).stem
        args = [str(c) for c in cmd[1:]]
        calls.append((name, args))
        if "--json_out" in args:
            path = Path(args[args.index("--json_out") + 1])
            path.write_text(json.dumps(evals[path.stem[len("eval_"):]]))
        return train_rc if name == "train_answer" else 0
    return run


@pytest.mark.parametrize("case", ["pass", "fail", "train_failed"])
def test_run_answer_hop_states_equal_jax(tmp_path, capsys, monkeypatch, case):
    init = tmp_path / "init"
    init.mkdir()
    (init / "meta.json").write_text(json.dumps({"font_size": 24, "dpi": 46, "lines": 6, "data": "words"}))
    evals = FAIL if case == "fail" else PASS
    train_rc = 3 if case == "train_failed" else 0
    records, calls = {}, {}
    for side in ("port", "jax"):
        out = tmp_path / "hop"  # the same out for both: the records name their files
        ship_root = tmp_path / f"ship_{side}"
        calls[side] = []
        args = ["--init_from", str(init), "--out", str(out), "--steps", "8", "--batch", "4",
                "--eval_examples", "4"]
        if side == "port":
            monkeypatch.setattr(thop, "_run", _stub_run(evals, calls[side], train_rc))
            thop.main([*args, "--ship_root", str(ship_root)])
        else:
            module = jax_script("run_answer_hop")
            monkeypatch.setattr(module, "_run", _stub_run(evals, calls[side], train_rc))
            monkeypatch.setattr(jconfig, "SHIPPED_CHECKPOINT_ROOT", ship_root)
            monkeypatch.setattr(sys, "argv", ["run_answer_hop.py", *args])
            module.main()
        capsys.readouterr()
        gate_record = ship_root / "ocr_bpe" / "gate" / "answer_hop.json"
        records[side] = ((out / "answer_hop.json").read_text(),
                         gate_record.read_text() if gate_record.exists() else None)
    assert records["port"] == records["jax"]
    status = json.loads(records["port"][0])
    want_status = {"pass": "shipped", "fail": "not_shipped_gate_failed", "train_failed": "train_failed:3"}[case]
    assert status["status"] == want_status
    if case != "train_failed":
        assert sorted(status["gate"]) == ["agg_beats_extractive", "extract_floor", "imitate_floor"]
        assert sorted(status["evals"]) == ["agg_real", "extract", "imitate_real", "imitate_words"]
    assert (records["port"][1] is not None) == (case == "pass")
    # The same command lines in the same order; the port's ship names its root.
    port_calls = [(n, [a for a in args if a != str(tmp_path / "ship_port")]) for n, args in calls["port"]]
    jax_calls = calls["jax"]
    assert [n for n, _ in port_calls] == [n for n, _ in jax_calls]
    for (name, got), (_, want) in zip(port_calls, jax_calls):
        if name == "ship_checkpoint":
            assert got[got.index("--root") + 1:] == want[want.index("--evidence"):]
            got = got[:got.index("--root")]
            want = want[:want.index("--evidence")]
        assert got == want, name


def _trained_checkpoint(tmp_path, step=2):
    """A tiny training run's step_NNN checkpoint (the port's format), and its params."""
    cfg = get_preset("tiny")
    model, opt, state = make_train_state(cfg, device="cpu", seed=4)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(0.01)
    state.step = step
    tcheckpoint.save_checkpoint(tmp_path / "run", state)
    return tmp_path / "run", {k: v.detach().clone() for k, v in state.params.items()}


def _ship_args(run, evidence):
    return ["--preset", "tiny", "--ckpt_dir", str(run), "--font_size", "24", "--dpi", "46", "--lines", "6",
            "--data", "real", "--tasks", "extract, answer", "--fonts", "builtin,dejavu_sans", "--steps", "7",
            "--note", "hop note", "--evidence", *map(str, evidence)]


def test_ship_checkpoint_loads_back_and_writes_the_jax_meta(tmp_path, capsys, monkeypatch):
    run, params = _trained_checkpoint(tmp_path)
    evidence = [tmp_path / "eval_agg_real.json", tmp_path / "missing.json"]
    evidence[0].write_text('{"task": "agg"}')
    root = tmp_path / "root"
    (root / "tiny" / "params_00000009").mkdir(parents=True)  # a stale ship with a larger step
    tship.main([*_ship_args(run, evidence), "--root", str(root)])
    got_out = capsys.readouterr().out
    assert sorted(p.name for p in (root / "tiny").iterdir()) == ["gate", "meta.json", "params_00000007"]
    runner = tcheckpoint.load_runner(get_preset("tiny"), root / "tiny", device="cpu")
    loaded = runner.model.state_dict()
    assert sorted(loaded) == sorted(params)
    assert all(torch.equal(loaded[k], params[k]) for k in params)
    assert (root / "tiny" / "params_00000007" / "checkpoint.pt").is_file()

    # The JAX script on the same arguments, its weights stubbed into a root of its own.
    jroot = tmp_path / "jroot"

    class Loaded:
        params = {}

    def fake_save(out, tree, step=0):
        path = Path(out) / f"params_{step:08d}"
        path.mkdir(parents=True)
        return path

    monkeypatch.setattr(jcheckpoint, "load_runner", lambda *a, **k: Loaded())
    monkeypatch.setattr(jcheckpoint, "save_params", fake_save)
    monkeypatch.setattr(jconfig, "SHIPPED_CHECKPOINT_ROOT", jroot)
    (jroot / "tiny" / "params_00000009").mkdir(parents=True)
    monkeypatch.setattr(sys, "argv", ["ship_checkpoint.py", *_ship_args(run, evidence)])
    jax_script("ship_checkpoint").main()
    want_out = capsys.readouterr().out
    assert (root / "tiny" / "meta.json").read_bytes() == (jroot / "tiny" / "meta.json").read_bytes()
    assert json.loads((root / "tiny" / "meta.json").read_text())["tasks"] == ["extract", "answer"]
    assert sorted(p.name for p in (root / "tiny" / "gate").iterdir()) == ["eval_agg_real.json"]
    assert (root / "tiny" / "gate" / "eval_agg_real.json").read_text() == '{"task": "agg"}'
    assert got_out.replace(str(root), "ROOT") == want_out.replace(str(jroot), "ROOT")


def _tree_state(root: Path):
    return sorted((str(p.relative_to(root)), p.stat().st_size, p.stat().st_mtime_ns) for p in root.rglob("*"))


@pytest.mark.parametrize("sub", ["", "ocr_bpe"])
def test_ship_checkpoint_refuses_the_jax_packages_root(tmp_path, capsys, sub):
    default = tconfig.SHIPPED_CHECKPOINT_ROOT
    before = _tree_state(default)
    with pytest.raises(SystemExit) as err:
        tship.main([*_ship_args(tmp_path / "none", []), "--root", str(default / sub)])
    assert err.value.code == 2 and "checkpoints/default/" in capsys.readouterr().err
    assert _tree_state(default) == before


def test_ship_root_defaults_outside_the_jax_packages_root(capsys):
    assert tconfig.PORT_SHIP_ROOT == tconfig.SHIPPED_CHECKPOINT_ROOT.parent / "torch"
    for module in (tship, thop):
        with pytest.raises(SystemExit):
            module.main(["--help"])
        assert "checkpoints/torch/" in capsys.readouterr().out


def test_export_stage_params(tmp_path, capsys):
    curr, out = tmp_path / "curr", tmp_path / "export"
    assert texport.main(["--curr", str(curr), "--out", str(out), "--preset", "tiny"]) == 0
    assert capsys.readouterr().out == "no curriculum state; nothing to export\n"
    run, params = _trained_checkpoint(tmp_path, step=4)
    curr.mkdir()
    run.rename(curr / "mixC_e0")
    (curr / "readB_e1").mkdir()  # a stage dir without a complete checkpoint
    (curr / "curriculum.json").write_text(json.dumps(
        {"stage": 5, "extension": 0, "init_from": str(curr / "readB_e1"), "status": "eval_failed:mixC_e0"}))
    (out / "readB_e1" / "params_00000500").mkdir(parents=True)  # an older stage export
    (out / "bpe_boost").mkdir()  # not a stage export: kept
    assert texport.main(["--curr", str(curr), "--out", str(out), "--preset", "tiny"]) == 0
    path = out / "mixC_e0" / "params_00000004"
    assert capsys.readouterr().out == f"exported: {path.resolve()}\n"
    assert sorted(p.name for p in out.iterdir()) == ["bpe_boost", "exported.json", "mixC_e0"]
    marker = json.loads((out / "exported.json").read_text())
    assert marker == {"tag": "mixC_e0", "step": 4, "preset": "tiny", "src": str(curr / "mixC_e0"),
                      "state": {"stage": 5, "extension": 0, "status": "eval_failed:mixC_e0"}}
    runner = tcheckpoint.load_runner(get_preset("tiny"), out / "mixC_e0", device="cpu")
    assert all(torch.equal(runner.model.state_dict()[k], v) for k, v in params.items())
    assert texport.main(["--curr", str(curr), "--out", str(out), "--preset", "tiny"]) == 0
    assert capsys.readouterr().out == "already exported: mixC_e0 step 4\n"
