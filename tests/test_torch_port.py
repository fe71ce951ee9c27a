"""Port boundaries: what the PyTorch package may import, and that it never
runs on the CPU unless asked to.
"""

from __future__ import annotations

import ast
import runpy
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.configs.smoke import reduced
from repro_torch.core.quant import quantize
from repro_torch.data.csr import build_spmm_layout
from repro_torch.kernels import dequant_matmul as tdqmm
from repro_torch.kernels import quant_pack as tqp
from repro_torch.kernels import spmm as tspmm
from repro_torch.kernels import topk_score as ttk
from repro_torch.launch import serve as tserve
from repro_torch.models import kgnn

ROOT = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "obs/metrics", "obs/trace", "obs/log", "obs/sinks", "serving/cache",
        "serving/refresh", "serving/engine", "serving/scorer",
        "training/checkpoint", "training/trainer", "training/step",
        "core/memory", "launch/train", "launch/serve", "models/gnn",
        "data/sampler", "configs/gcn_cora", "configs/base",
        "configs/smoke", "launch/roofline", "launch/dryrun",
        "launch/report", "kernels/autotune", "obs/cost",
        "training/optimizer", "models/layers", "examples/quickstart",
        "examples/train_kgnn", "examples/train_lm")} <= scanned
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_without_cuda_raise(monkeypatch):
    """Without a card, anything not given ``device="cpu"`` raises; nothing
    silently runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get("kgat")).model_cfg
    ds = tserve.reduced_dataset(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kgnn.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_spmm_layout(ds.src, ds.dst, n_dst=ds.n_nodes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "kgat", "--requests", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "kgat", "--bits", "8", "--two-stage", "4",
                     "--item-shards", "2", "--cache", "16",
                     "--refresh-steps", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve_kgnn(cfg, ds, kgnn.init_params(cfg, device="cpu"),
                          bits=8)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel launcher takes only CUDA tensors (the dispatcher sends CPU
    tensors to the plain version before it is reached)."""
    src = np.arange(8) % 4
    layout = build_spmm_layout(src, src[::-1].copy(), n_dst=4, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tspmm.spmm_cuda(torch.zeros((4, 2)), None, layout)
    q = quantize(torch.randn((4, 3)), 1, bits=2)
    for launch in (lambda: tspmm.sddmm_cuda(torch.zeros((4, 3)),
                                            torch.zeros((4, 3)), layout),
                   lambda: tspmm.dequant_sddmm_cuda(q, torch.zeros((4, 3)),
                                                    layout),
                   lambda: tdqmm.dequant_matmul_cuda(q, torch.zeros((4, 2))),
                   lambda: ttk.coarse_topm_cuda(
                       torch.zeros((2, 3)), torch.ones((2, 2)), q,
                       torch.full((2, 1), -1, dtype=torch.int32), m=2),
                   lambda: tqp.dequant_unpack_cuda(q.packed, q.scale, q.zero,
                                                   bits=2, dim=3)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch()


def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path, monkeypatch,
                                                    capsys):
    """No card: exit 2 before anything runs. A card but no checkout around
    the script (``chip_smoke.py`` alone in a directory): exit 2 too. Neither
    prints a result."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, has_card in ((ROOT / "chip_smoke.py", False), (alone, True)):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: has_card)
        with pytest.raises(SystemExit) as exc:
            runpy.run_path(str(script), run_name="__main__")
        assert exc.value.code == 2
        out = capsys.readouterr()
        assert '"ok"' not in out.out
        assert ("is_available() is false" if not has_card
                else "no src/repro_torch") in out.err
