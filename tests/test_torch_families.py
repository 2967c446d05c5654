"""The reference's dense and MoE architectures that the port took last,
on the CPU against the JAX package: qwen1.5-110b (q/k/v biases),
command-r-plus-104b, nemotron-4-15b (squared-ReLU MLP, LayerNorm, partial
rotary) and qwen3-moe-235b-a22b (MoE without shared experts), plus the
registry of all ten. The VLM and the encoder-decoder are in
``tests/test_torch_encdec.py``; the set-up, the checks and their
tolerances in ``tests/_torch_families.py``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.launch.serve import GenRequest as JRequest
from repro.serving import ContinuousLMEngine as JEngine
from repro.serving import supports_continuous as j_supports_continuous

import _torch_families as fam
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import serve
from repro_torch.launch.serve import GenRequest
from repro_torch.models import transformer as tt
from repro_torch.serving import ContinuousLMEngine, supports_continuous

ARCHS = ("qwen1.5-110b", "command-r-plus-104b", "nemotron-4-15b",
         "qwen3-moe-235b-a22b")
NEW = ARCHS + ("internvl2-76b", "seamless-m4t-large-v2")


# ------------------------------------------------------------ registry


def test_list_archs_equals_the_reference_ten():
    assert list_archs() == j_list_archs()
    assert len(list_archs()) == 10
    for arch in NEW:
        assert get_arch(arch).source == j_get_arch(arch).source


@pytest.mark.parametrize("arch", sorted(j_list_archs()))
def test_supports_continuous_agrees_with_reference(arch):
    for size in ("smoke", "full"):
        assert supports_continuous(getattr(get_arch(arch), size)) == \
            j_supports_continuous(getattr(j_get_arch(arch), size))


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_reference(arch):
    """Every field the port's ModelConfig shares with the reference's, at
    both sizes (the policy's shared fields too)."""
    for size in ("smoke", "full"):
        tcfg, jcfg = getattr(get_arch(arch), size), getattr(j_get_arch(arch),
                                                             size)
        for f in dataclasses.fields(tcfg):
            if f.name == "policy":
                for g in dataclasses.fields(tcfg.policy):
                    if hasattr(jcfg.policy, g.name):
                        assert getattr(tcfg.policy, g.name) == \
                            getattr(jcfg.policy, g.name), (size, g.name)
            else:
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (
                    size, f.name)


def test_unknown_family_and_act_raise():
    tcfg = get_arch("qwen1.5-110b").smoke
    for cfg in (dataclasses.replace(tcfg, family="cnn"),
                dataclasses.replace(tcfg, act="silu")):
        with pytest.raises(NotImplementedError, match="families are"):
            tt.layer_groups(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_groups_and_param_trees_equal_reference(arch):
    fam.check_layer_groups_and_param_trees(arch)


# ------------------------------------------------------------- numerics


@pytest.mark.parametrize("pack_acts", [True, False])
def test_relu2_down_projection_exact_on_carried_activations(pack_acts):
    fam.check_mlp_down_projection("relu2", pack_acts)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_reference(arch):
    fam.check_forward_and_loss(arch)


@pytest.mark.parametrize("pack_acts", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(arch, pack_acts):
    fam.check_prefill_and_decode(arch, pack_acts)


# -------------------------------------------------------------- serving


@pytest.mark.parametrize("pack_acts", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_server_generate_equals_reference(arch, pack_acts):
    fam.check_server_generate(arch, pack_acts)


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "qwen3-moe-235b-a22b"])
def test_engine_greedy_tokens_equal_reference(arch):
    """The continuous engine admits a squared-ReLU dense stack and an MoE
    stack without shared experts, as the reference's does, and gives the
    JAX engine's tokens on the CLI-shaped mixed load."""
    jcfg, tcfg, _, packed = fam.model(arch)
    rng = np.random.RandomState(0)
    load = [(rng.randint(0, 512, (int(rng.randint(4, 17)),)).astype(
        np.int32), 6 if i % 4 == 0 else 2) for i in range(6)]
    je = JEngine(jcfg, params=jax.tree.map(jnp.asarray, packed),
                 batch_slots=fam.SLOTS, max_len=fam.MAX_LEN, backend="xla")
    want = [r.out_tokens for r in je.serve([JRequest(p.copy(), n)
                                            for p, n in load])]
    eng = ContinuousLMEngine(tcfg, fam.t_(packed), batch_slots=fam.SLOTS,
                             max_len=fam.MAX_LEN, device="cpu")
    got = [r.out_tokens for r in eng.serve([GenRequest(p.copy(), n)
                                            for p, n in load])]
    assert got == want


def test_serve_cli_qwen_through_the_engine_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "qwen1.5-110b", "--device", "cpu", "--smoke",
                    "--batch", "2", "--new-tokens", "3"])
    text = buf.getvalue()
    assert "generated 12 tokens over 8 requests" in text
    assert "recompiles_after_warmup=0" in text
    assert "K1 + K3" in text and "sample:" in text
