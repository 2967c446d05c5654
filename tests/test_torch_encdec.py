"""The reference's VLM and encoder-decoder on the port, on the CPU against
the JAX package: internvl2-76b (the patch frontend's projected embeddings
in front of the tokens) and seamless-m4t-large-v2 (a non-causal encoder
over the audio frontend's embeddings, a decoder that cross-attends it,
GELU MLPs). The set-up, the checks and their tolerances are in
``tests/_torch_families.py``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch.serve import GenRequest as JRequest
from repro.launch.serve import Server as JServer

import _torch_families as fam
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.launch.serve import GenRequest, Server
from repro_torch.launch import train as ttrain

ARCHS = ("internvl2-76b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_groups_and_param_trees_equal_reference(arch):
    fam.check_layer_groups_and_param_trees(arch)


@pytest.mark.parametrize("pack_acts", [True, False])
def test_gelu_down_projection_exact_on_carried_activations(pack_acts):
    fam.check_mlp_down_projection("gelu", pack_acts)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_reference(arch):
    fam.check_forward_and_loss(arch)


@pytest.mark.parametrize("pack_acts", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(arch, pack_acts):
    fam.check_prefill_and_decode(arch, pack_acts)


@pytest.mark.parametrize("pack_acts", [True, False])
def test_vlm_server_generate_equals_reference(pack_acts):
    """The VLM through ``Server.generate``, text-only: the reference's
    ``generate`` feeds tokens alone."""
    fam.check_server_generate("internvl2-76b", pack_acts)


def test_server_refuses_the_audio_family():
    """The reference's ``generate`` feeds no source and fails with a
    ``KeyError`` in its prefill; the port's raises a ``ValueError`` that
    says why, and the CLI exits with the reason."""
    jcfg, tcfg, _, packed = fam.model("seamless-m4t-large-v2")
    js = JServer(jcfg, jax.tree.map(jnp.asarray, packed),
                 batch_slots=fam.SLOTS, max_len=fam.MAX_LEN, backend="xla")
    with pytest.raises(KeyError):
        js.generate([JRequest(np.arange(3, dtype=np.int32), 2)])
    srv = Server(tcfg, fam.t_(packed), batch_slots=fam.SLOTS,
                 max_len=fam.MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="needs a source"):
        srv.generate([GenRequest(np.arange(3, dtype=np.int32), 2)])
    with pytest.raises(SystemExit, match="encoder-decoder"):
        serve.main(["--arch", "seamless-m4t-large-v2", "--device", "cpu",
                    "--smoke"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_vlm_and_refuses_audio(arch):
    """The training CLI on the smoke config: the VLM trains on tokens
    alone, as the reference's ``Trainer`` feeds it; the encoder-decoder's
    ``Trainer`` raises, since the token stream carries no source."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16"]
    if arch == "seamless-m4t-large-v2":
        with pytest.raises(ValueError, match="carries none"):
            ttrain.main(argv)
        return
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.main(argv)
    assert "done: 2 steps of internvl2-76b-smoke" in buf.getvalue()


def test_serve_cli_vlm_through_the_static_server_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "internvl2-76b", "--device", "cpu", "--smoke",
                    "--batch", "2", "--new-tokens", "3"])
    text = buf.getvalue()
    assert "doesn't fit the continuous slot arena" in text
    assert "generated 6 tokens" in text and "static batch" in text
    assert "K1 + K3" in text and "sample:" in text
