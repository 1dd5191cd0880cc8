"""Port packing (mi_optimize_tpu_torch.core.packing) against the JAX package:
bit-identical words, and round trips through the int32 bit-view, including
the codes with the top bit set that an arithmetic shift would sign-extend."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.core import packing as jpacking
from mi_optimize_tpu.core.qparams import qrange as jqrange
from mi_optimize_tpu_torch.core import packing
from mi_optimize_tpu_torch.core.qparams import qrange


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("unsigned", [True, False])
def test_words_bit_identical_to_jax(bits, unsigned):
    r = qrange(bits, unsigned)
    vals = np.random.default_rng(bits).integers(r.qmin, r.qmax + 1, size=(48, 64)).astype(np.int32)
    ref = jpacking.pack_weight(vals, bits, jqrange(bits, unsigned))
    ref_dev = np.asarray(jpacking.pack_weight_device(jnp.asarray(vals), bits,
                                                     jqrange(bits, unsigned)))
    got = packing.pack_weight(vals, bits, r)
    got_dev = packing.pack_weight_device(torch.from_numpy(vals), bits, r)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(got_dev.numpy().view(np.uint32), ref_dev)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("unsigned", [True, False])
def test_unpack_roundtrip_top_bit_codes(bits, unsigned):
    r = qrange(bits, unsigned)
    rng = np.random.default_rng(100 + bits)
    vals = rng.integers(r.qmin, r.qmax + 1, size=(7, 96)).astype(np.int32)
    vals[:, :8] = r.qmax  # stored field all ones: top bit set in every word
    packed = packing.pack(vals, bits, r)
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  jpacking.pack(vals, bits, jqrange(bits, unsigned)))
    np.testing.assert_array_equal(packing.unpack(packed, bits, r, 96).numpy(), vals)
    if 32 % bits == 0:
        pw = packing.pack_weight(vals, bits, r)
        np.testing.assert_array_equal(packing.unpack_weight(pw, bits, r, 96).numpy(), vals)


def test_unpack_words_masks_every_field():
    words = torch.tensor([[-1, 0x7FFFFFFF]], dtype=torch.int32)  # 0xFFFFFFFF, 0x7FFFFFFF
    fields = packing.unpack_words(words, 4)
    assert fields.shape == (8, 2)
    assert fields[:, 0].tolist() == [15] * 8
    assert fields[:, 1].tolist() == [15] * 7 + [7]


def test_out_of_range_rejected():
    with pytest.raises(ValueError):
        packing.pack(np.array([[16] * 8]), 4, qrange(4, True))
