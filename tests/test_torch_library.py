"""PyTorch port: the two library functions that nothing in either package calls.

- ``models.layers.conv_stack`` against the JAX package's ``conv_stack`` (in a
  flax ``nn.Sequential``) from the same numpy-drawn weights through
  ``bridge.conv_stack_params_from_flax``, 2-D and 3-D, within F32_TOL;
- ``training.checkpoint.restore_params``: strict without ``relax``; with it,
  the target's entries that the file lacks keep their values and the file's
  entries that the target lacks are dropped (the reference's
  ``restore_params(path, target_params, relax)``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.models.layers import conv_stack as jax_conv_stack
from opticalflowscivis_tpu_torch.bridge import conv_stack_params_from_flax
from opticalflowscivis_tpu_torch.models.layers import conv_stack
from opticalflowscivis_tpu_torch.training.checkpoint import restore_params, save_state

F32_TOL = 1e-5  # float32 convolutions of two libraries
FEATURES, STRIDES = (4, 6, 5), (2, 1, 2)


@pytest.mark.parametrize("ndim", [2, 3])
def test_conv_stack_matches_jax(ndim):
    """The same layers in the same order: strides, channels, PReLU; one
    output of the stack within F32_TOL."""
    rng = np.random.default_rng(ndim)
    shape = (2,) + (12,) * ndim + (3,)
    x = rng.standard_normal(shape).astype(np.float32)
    jstack = fnn.Sequential(jax_conv_stack(FEATURES, ndim, STRIDES))
    shapes = jax.eval_shape(jstack.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    params = jax.tree_util.tree_map(
        lambda s: rng.uniform(-0.4, 0.4, s.shape).astype(np.float32), shapes)
    want = np.asarray(jstack.apply(params, x))

    layers = conv_stack(FEATURES, ndim, STRIDES, 3, torch.Generator().manual_seed(0))
    assert [layer.conv.stride for layer in layers] == [(s,) * ndim for s in STRIDES]
    stack = torch.nn.Sequential(*layers)
    stack.load_state_dict(conv_stack_params_from_flax(params), strict=True)
    got = stack(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).detach().numpy()
    assert got.shape == want.shape == (2,) + (12 // 4,) * ndim + (5,)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


def _saved(path, module):
    opt = torch.optim.SGD(module.parameters(), lr=0.1)
    save_state(str(path), module, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0), 3)


def test_restore_params_relax_keeps_what_the_file_lacks(tmp_path):
    """A checkpoint of a two-layer stack into a three-layer one: strict
    refuses it; ``relax`` loads the two layers, keeps the third as it was and
    names it; the other way round it drops the file's extra layer."""
    gen = torch.Generator().manual_seed(1)
    small = torch.nn.Sequential(*conv_stack(FEATURES[:2], 2, STRIDES[:2], 3, gen))
    large = torch.nn.Sequential(*conv_stack(FEATURES, 2, STRIDES, 3, gen))
    _saved(tmp_path / "small.ckpt", small)
    third = {k: v.clone() for k, v in large.state_dict().items() if k.startswith("2.")}

    with pytest.raises(RuntimeError, match="Missing key"):
        restore_params(str(tmp_path / "small.ckpt"), large)
    kept = restore_params(str(tmp_path / "small.ckpt"), large, relax=True)
    assert sorted(kept) == sorted(third) == ["2.conv.bias", "2.conv.weight", "2.prelu.slope"]
    state = large.state_dict()
    for k, v in small.state_dict().items():
        assert torch.equal(state[k], v), k
    for k, v in third.items():
        assert torch.equal(state[k], v), k

    _saved(tmp_path / "large.ckpt", large)
    fresh = torch.nn.Sequential(*conv_stack(FEATURES[:2], 2, STRIDES[:2], 3,
                                            torch.Generator().manual_seed(2)))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        restore_params(str(tmp_path / "large.ckpt"), fresh)
    assert restore_params(str(tmp_path / "large.ckpt"), fresh, relax=True) == []
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k]), k
