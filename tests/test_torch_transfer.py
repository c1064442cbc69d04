"""``sciml_pde_torch/utils/transfer.py::device_put_chunked`` against the
JAX package's: equal to the input (and to JAX's transfer) bit for bit in
the ragged-tail, exact-multiple, one-chunk, 0-d, one-row and
already-a-tensor cases, with the number of chunks and the staging bytes (two
slots of one chunk) checked; the bf16 conversion per chunk against
``torch.as_tensor``'s; ``WindowedTrajectories(to_device=False)`` keeping
a host store."""

import numpy as np
import pytest
import torch

from sciml_pde_tpu.utils.transfer import device_put_chunked as jax_put
from sciml_pde_torch.data.windows import WindowedTrajectories
from sciml_pde_torch.utils import transfer
from sciml_pde_torch.utils.transfer import device_put_chunked


@pytest.mark.parametrize("shape,dtype,chunk,chunks,slot_rows", [
    ((7, 5, 3), np.float32, 120, 4, 2),    # 60-byte rows: 3 chunks of 2 and a tail of 1
    ((6, 4), np.int32, 32, 3, 2),          # an exact multiple
    ((5, 3), np.float32, 1000, 0, 0),      # one copy: at or below the chunk
    ((9, 2), np.float32, 4, 9, 1),         # a chunk smaller than a row: one row each
])
def test_chunked_equals_input(shape, dtype, chunk, chunks, slot_rows):
    a = np.random.default_rng(0).normal(size=shape).astype(dtype)
    transfer.LAST_STATS.update(chunks=0, staging_bytes=0)
    out = device_put_chunked(a, max_chunk_bytes=chunk, device="cpu")
    assert out.dtype == torch.from_numpy(a).dtype and tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), a)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_put(a, max_chunk_bytes=chunk)))
    assert transfer.LAST_STATS["chunks"] == chunks
    row = a.nbytes // shape[0]
    assert transfer.LAST_STATS["staging_bytes"] == 2 * slot_rows * row <= 2 * max(chunk, row)


def test_zero_d_one_row_and_tensor_cases():
    transfer.LAST_STATS.update(chunks=0, staging_bytes=0)
    z = np.float32(3.5)
    assert device_put_chunked(np.asarray(z), max_chunk_bytes=1, device="cpu").item() == 3.5
    one = np.arange(40, dtype=np.float32).reshape(1, 40)
    np.testing.assert_array_equal(device_put_chunked(one, max_chunk_bytes=8,
                                                     device="cpu").numpy(), one)
    assert transfer.LAST_STATS["chunks"] == 0  # both went in one copy
    t = torch.ones(4, 4)
    assert device_put_chunked(t, max_chunk_bytes=8, device="cpu") is t


def test_bf16_conversion_per_chunk():
    a = np.random.default_rng(1).normal(size=(10, 3, 4)).astype(np.float32)
    out = device_put_chunked(a, max_chunk_bytes=50, device="cpu", dtype=torch.bfloat16)
    assert transfer.LAST_STATS["chunks"] == 5  # 24-byte bf16 rows, 2 a chunk
    assert torch.equal(out, torch.as_tensor(a).to(torch.bfloat16))


def test_windowed_store_on_host_or_device():
    a = np.random.default_rng(2).normal(size=(3, 6, 4, 4, 2)).astype(np.float32)
    grid = np.zeros((4, 4, 2), np.float32)
    host = WindowedTrajectories(a, grid, initial_step=2, device="cpu", to_device=False)
    assert isinstance(host.data, np.ndarray) and np.array_equal(host.data, a)
    bf = WindowedTrajectories(a, grid, initial_step=2, device="cpu", to_device=False,
                              dtype=torch.bfloat16)
    assert bf.data.dtype == torch.bfloat16 and bf.data.device.type == "cpu"
    dev = WindowedTrajectories(a, grid, initial_step=2, device="cpu")
    assert isinstance(dev.data, torch.Tensor) and np.array_equal(dev.data.numpy(), a)
    assert np.array_equal(host.window_index(), dev.window_index())
