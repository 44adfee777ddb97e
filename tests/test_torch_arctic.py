"""arctic-480b in the port (top-k MoE with SwiGLU experts and the dense
residual MLP, on the unfused branch of a fused RMSNorm stack) on the CPU
against the JAX package, and its chunked, speculative and prefix-cache
runs against the port's own plain runs, through the helpers of
``test_torch_grok.py``.

The smoke config (2 layers, d_model 128, 4 heads of 64 dims, 4 experts,
top 2, the residual MLP of d_ff 256) runs in fp32 at capacity factor
1.25: lock-step in masked and gather mode (gates, expert choices, logits,
``moe_lb_loss``), int4 weights (the residual MLP, attention and the head
in int4 through the int4 matmul and the int4 fused linear, the experts
dense), teacher-forced paged steps over int8 pages, the continuous engine
dense and paged, single-step and fused, against the reference; at factor
8.0 chunk 8, ``spec_k`` 2 and the prefix cache against the port's own
runs; the launcher.  Tolerances as in ``test_torch_grok.py``."""
import pytest

from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models.model import LanguageModel
from repro_torch.launch import serve as launch_serve
from test_torch_grok import (cfgs, engines, int4_lockstep, lockstep,
                             make_world, own_runs, paged_int8,
                             reference_engine)  # noqa: F401  (a fixture)

ARCH = "arctic-480b"
JCFG, CFG = cfgs(ARCH)


@pytest.fixture(scope="module")
def world():
    return make_world(JCFG, CFG)


def test_config_is_moe_swiglu_with_dense_residual():
    full = get_config(ARCH)
    assert (full.num_experts, full.top_k, full.mlp_act, full.dense_residual,
            full.num_heads // full.num_kv_heads) == (128, 2, "swiglu", True,
                                                     7)
    for blk in LanguageModel(CFG, device="cpu", seed=0).params()["blocks"]:
        inner = blk["ffn"]["inner"]
        assert not layers.mlp_fusable(inner)
        assert set(inner["dense"]) == {"gu", "down"}
        assert inner["dense"]["gu"]["w"].shape == (128, 512)


@pytest.mark.parametrize("mode", ["masked", "gather"])
def test_lockstep_matches_reference(world, mode, monkeypatch):
    lockstep(world, ARCH, mode, monkeypatch)


def test_int4_weights_match_reference(world, monkeypatch):
    int4_lockstep(world, ARCH, monkeypatch)


def test_paged_decode_int8_matches_reference(world, monkeypatch):
    paged_int8(world, JCFG, CFG, monkeypatch)


@pytest.mark.parametrize("kv_mode,steps", [
    ("dense", 1), ("dense", 4), ("paged", 1), ("paged", 4)])
def test_engines_match_reference(world, reference_engine, kv_mode, steps,
                                 monkeypatch):
    engines(world, ARCH, reference_engine, kv_mode, steps, monkeypatch)


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_chunked_speculative_prefix_equal_plain(world, kv_mode):
    own_runs(world, ARCH, kv_mode)


@pytest.mark.parametrize("extra", [
    ["--int4"], ["--continuous", "--paged-kv", "--kv-dtype", "int8",
                 "--decode-steps", "4"], ["--continuous", "--gather"]])
def test_launcher_arctic_on_cpu(extra, capsys):
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "21",
                       "--new-tokens", "3", *extra])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke: routing: " in out
    assert ("paged KV: peak" in out) == ("--paged-kv" in extra)
