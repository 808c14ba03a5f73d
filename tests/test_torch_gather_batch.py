"""The loaders' one-launch batch gather (``gather_rows.gather_batch``)
on the CPU against the JAX package: its plain version, over an epoch
order uploaded by ``index_tensor``, against ``pk.gather_rows_packed`` in
interpret mode, array by array, bitwise; and what it refuses.  On a CPU
tensor the wrapper takes its plain version and counts no launch; the
CUDA kernel is held against this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.ops import pallas_kernels as pk  # noqa: E402
from veles_tpu_torch.ops.kernels import gather_rows as gr  # noqa: E402

torch.set_num_threads(2)


BATCH_CASES = {
    # the LM's train class: tokens, labels, per-position masks
    "lm_three_arrays": ([(np.int32, (24,)), (np.int32, (24,)),
                         (np.float32, (24,))], 50, 16, 16, 0),
    # a padded tail at the epoch's end, every copy unit (row bytes 21,
    # 10, 12)
    "odd_rows_padded_tail": ([(np.uint8, (3, 7)), (np.int16, (5,)),
                              (np.float32, (3,))], 37, 8, 5, 32),
    "one_array": ([(np.float32, (2, 3))], 9, 4, 1, 8),
}


@pytest.mark.parametrize("case", list(BATCH_CASES), ids=list(BATCH_CASES))
def test_gather_batch_plain_matches_jax_kernel_bitwise(rng, case):
    """``gather_batch``'s plain version (every array of a class, rows
    ``perm[offset:offset + m]``, and the padding mask) against
    ``pk.gather_rows_packed`` in interpret mode, array by array, over an
    epoch order uploaded by ``index_tensor`` (padded with index 0)."""
    specs, n, m, count, offset = BATCH_CASES[case]
    arrays = [rng.integers(0, 1 << 14, (n,) + s).astype(dt)
              if np.issubdtype(dt, np.integer)
              else rng.standard_normal((n,) + s).astype(dt)
              for dt, s in specs]
    order = rng.permutation(n)[:offset + count]
    perm = gr.index_tensor(order, n, offset + m, "cpu")
    assert perm.dtype == torch.int32
    assert perm[offset + count:].eq(0).all()
    outs = [torch.empty((m,) + a.shape[1:], dtype=torch.from_numpy(a).dtype)
            for a in arrays]
    mask = torch.empty(m)
    before = gr.launches.count
    gr.gather_batch([torch.from_numpy(a) for a in arrays], outs, perm,
                    offset, count, mask)
    assert gr.launches.count == before
    idx = np.asarray(perm[offset:offset + m])
    for a, o in zip(arrays, outs, strict=True):
        packed, f, sample = pk.pack_rows(jnp.asarray(a))
        ref = np.asarray(pk.unpack_rows(pk.gather_rows_packed(
            packed, jnp.asarray(idx), interpret=True), f, sample))
        assert o.numpy().tobytes() == ref.tobytes()
    assert mask.tolist() == [1.0] * count + [0.0] * (m - count)


def test_gather_batch_refuses_what_it_cannot_hold():
    """The epoch order is checked once, against the row count; outputs,
    offsets and the mask are checked per call."""
    data = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    for bad in ([0, 4], [-1]):
        with pytest.raises(IndexError, match="out of range"):
            gr.index_tensor(np.asarray(bad), 4, 8, "cpu")
    with pytest.raises(ValueError):                  # longer than length
        gr.index_tensor(np.arange(4), 4, 3, "cpu")
    perm = gr.index_tensor(np.arange(4), 4, 4, "cpu")
    out = torch.empty(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError):                  # rows past the order
        gr.gather_batch([data], [out], perm, 3, 2)
    with pytest.raises(ValueError):                  # wrong output dtype
        gr.gather_batch([data], [out.float()], perm, 0, 2)
    with pytest.raises(ValueError):                  # count above m
        gr.gather_batch([data], [out], perm, 0, 3)
    with pytest.raises(ValueError):                  # too many arrays
        gr.gather_batch([data] * 9, [out] * 9, perm, 0, 2)
    gr.gather_batch([data], [out], perm, 2, 2)
    assert out.tolist() == [[6, 7, 8], [9, 10, 11]]
