"""The port's own rules, checked on the CPU.

- paddle_tpu_torch, chip_smoke.py and tools/torch_serving_profile.py
  import neither JAX nor paddle_tpu (an AST scan of every import);
- entry points default to the CUDA card and raise without one, rather
  than run on the CPU unasked;
- kernel wrappers on CPU tensors take the plain versions and launch
  nothing;
- chip_smoke.py exits non-zero with no result line where it cannot run.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import (AdamW, ErnieConfig, ErnieForPretraining,
                              GPTConfig, GPTForCausalLM, ServingConfig,
                              ServingEngine)
from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")
TINY = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            max_position_embeddings=64)
TINY_ERNIE = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=1,
                  num_attention_heads=1, intermediate_size=128,
                  max_position_embeddings=128)


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "tools" / "torch_serving_profile.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_paddle_tpu(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(GPTConfig(**TINY))
    model = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, ServingConfig(num_blocks=8))
    eng = ServingEngine(model, ServingConfig(num_blocks=8), device="cpu")
    assert eng.device == torch.device("cpu")


def test_training_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ErnieConfig(**TINY_ERNIE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieForPretraining(cfg)
    model = ErnieForPretraining(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdamW(model.parameters())
    AdamW(model.parameters(), device="cpu")


def test_engine_and_model_must_share_a_device():
    model = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="model lives on"):
        ServingEngine(model, ServingConfig(num_blocks=8), device="meta")


def test_cpu_wrappers_take_plain_versions_and_launch_nothing():
    before = (tfa.KERNEL.launches, tpa.KERNEL.launches)
    q = torch.randn(1, 130, 2, 16)
    out, lse = tfa.flash_attention_fwd(q, q, q, causal=True)
    want, want_lse = tfa.flash_attention_plain(q, q, q, causal=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    pool = torch.randn(5, 4, 2, 16)
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    pos = torch.tensor([[5], [2]], dtype=torch.int32)
    qd = torch.randn(2, 1, 2, 16)
    got = tpa.paged_attention(qd, pool, pool, table, pos, block_size=4)
    assert torch.equal(got, tpa.paged_attention_plain(
        qd, pool, pool, table, pos, block_size=4))
    assert (tfa.KERNEL.launches, tpa.KERNEL.launches) == before


def test_cpu_training_step_launches_nothing():
    """An ERNIE step through the flash path (seq 128, attention dropout)
    on CPU tensors: plain versions only, no kernel counted."""
    kernels = (tfa.KERNEL, tfa.DKV_KERNEL, tfa.DQ_KERNEL)
    before = [k.launches for k in kernels]
    model = ErnieForPretraining(ErnieConfig(**TINY_ERNIE), device="cpu")
    ids = torch.randint(0, 1024, (1, 128))
    model.pretraining_loss(ids, ids).backward()
    AdamW(model.named_parameters(), device="cpu").step()
    assert [k.launches for k in kernels] == before


def test_kernel_sources_exist_and_are_keyed_by_content():
    for src in _cuda.KERNEL_SOURCES:
        assert (_cuda.CSRC / src).is_file()
        lib = _cuda.library_path(src)
        assert lib.parent == _cuda.BUILD_DIR and lib.name.startswith(
            Path(src).stem + "-")


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # hide any card
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    r = _smoke(ROOT)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _smoke(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
