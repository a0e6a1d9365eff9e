"""The port's ``entry()`` (``idunno_tpu_torch/entry.py``) against the JAX
package's (``__graft_entry__.py:entry``), on the CPU.

The JAX entry's variables are carried into the port's ResNet-18 by
``models/convert.py:resnet_state_dict``; both forwards then run on the
same seeded non-zero uint8 batch. The JAX entry computes in bf16 (its
model's default), the port's in f32 on K1's bf16 output (its plain
version here), so the logits are held to the JAX model applied in f32 to
the same variables: within 1e-2 of the largest |logit|, the bf16
rounding of the model's input (2^-9 relative at most) carried through
the network, as ``tests/test_torch_engine.py`` holds the engine's
``kernel`` mode. Top-1 must equal the JAX entry's forward on every image.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from idunno_tpu.models import create_model as jax_create_model
from idunno_tpu.ops.preprocess import preprocess_batch as jax_preprocess
from idunno_tpu_torch.entry import entry, logits
from idunno_tpu_torch.models.convert import resnet_state_dict
from tests.torch_workers import share_cores  # noqa: F401

REL_TOL = 1e-2


@pytest.fixture(scope="module")
def pair():
    jfwd, (variables, jimages) = graft.entry()
    fwd, (model, images) = entry(device="cpu")
    return jfwd, variables, jimages, fwd, model, images


def test_entry_matches_jax_entry_on_carried_weights(pair):
    jfwd, variables, jimages, fwd, model, images = pair
    assert images.shape == tuple(jimages.shape) == (8, 256, 256, 3)
    assert images.dtype == torch.uint8 and jimages.dtype == jnp.uint8
    assert images.device.type == "cpu" and not model.training
    assert not images.any()
    model.load_state_dict(resnet_state_dict(jax.tree.map(np.asarray,
                                                         variables)))
    batch = np.random.default_rng(0).integers(0, 256, (8, 256, 256, 3),
                                              dtype=np.uint8)
    f32 = jax_create_model("resnet", dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v, x: f32.apply(
        v, jax_preprocess(x), train=False))(variables, jnp.asarray(batch)))
    with torch.inference_mode():
        got = logits(model, torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * float(np.abs(want).max()))
    jidx, jprob = jax.jit(jfwd)(variables, jnp.asarray(batch))
    idx, prob = fwd(model, torch.from_numpy(batch))
    assert idx.dtype == torch.int32 and prob.dtype == torch.float32
    assert idx.tolist() == np.asarray(jidx).tolist()
    assert idx.tolist() == want.argmax(-1).tolist()
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), rtol=0,
                               atol=1e-3)
    out_idx, _ = fwd(model, images)          # the example input runs
    assert out_idx.shape == (8,)


def test_entry_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without ``device`` the step goes to the card: where none is
    present it raises, naming ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
