"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: random flax
variables made with numpy from a seed, a flax ``params`` tree under the
port's names, and the comparison of a port tensor with a JAX array."""
import jax
import numpy as np
import torch

from dfvod_tpu_torch.utils.convert import port_key


def random_variables(init_fn, seed=0):
    """Flax variables with the structure ``init_fn()`` returns (traced with
    ``jax.eval_shape``, never run), filled with numpy draws from ``seed``:
    kernels N(0, 1/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2),
    embeddings N(0, 1), BN running variances U(0.5, 1.5). Every value is
    random, so parity covers zero-initialized kernels too."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.default_rng(seed)

    def fill(path, sds):
        collection, leaf = path[0].key, path[-1].key
        shape = tuple(sds.shape)
        n = rng.standard_normal(shape)
        if leaf == "kernel":
            v = n / np.sqrt(np.prod(shape[:-1]))
        elif leaf in ("var", "running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "scale" or (collection == "constants"
                                 and leaf == "weight"):
            v = 1.0 + 0.1 * n
        elif leaf in ("level_embed", "query_embed"):
            v = n
        else:                       # bias, mean, running_mean
            v = 0.1 * n
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def t2n(x):
    return x.detach().float().cpu().numpy()


def assert_close(port, ref, atol, rtol, err_msg=""):
    np.testing.assert_allclose(t2n(port) if torch.is_tensor(port) else port,
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol, err_msg=err_msg)


def flat_params(tree):
    """{port state-dict key: numpy array in the port's layout} of a flax
    ``params`` tree."""
    out = {}
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key, val = port_key("params", tuple(k.key for k in kp), np.asarray(v))
        out[key] = val
    return out
