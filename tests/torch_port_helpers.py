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


def make_frames(channels, seed=0, B=2, H=96, W=128):
    """uint8 frames padded bottom/right: image 1 keeps a 60 x 84 block."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, H, W, channels), dtype=np.uint8)
    sizes = np.array([[H, W], [60, 84]][:B])
    for i, (h, w) in enumerate(sizes):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    return imgs, sizes


def private_jax_native(directory):
    """Point the JAX package's native library (``dfvod_tpu/data/native.py``)
    at a copy built into ``directory`` with ``native/Makefile``'s own
    flags; returns a function that restores the shared path.

    ``native.available()`` builds ``native/libdfvod_native.so`` in place on
    first use and caches a failed load for the life of the process. Under
    ``pytest -n`` every worker calls it while collecting
    ``tests/test_native.py``, so one worker can load the file another is
    still writing, and then sees no library for the rest of the run. A
    copy of its own, built once per worker, has no such race."""
    import os
    import subprocess

    from dfvod_tpu.data import native as j_native

    lib = os.path.join(str(directory), "libdfvod_native.so")
    subprocess.run(["make", "-s", "-C", os.path.dirname(j_native._LIB_PATH),
                    f"TARGET={lib}"], check=True, capture_output=True)
    shared = j_native._LIB_PATH
    j_native._LIB_PATH = lib
    j_native._lib.cache_clear()
    assert j_native.available(), lib

    def restore():
        j_native._LIB_PATH = shared
        j_native._lib.cache_clear()

    return restore
