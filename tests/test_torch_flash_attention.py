"""K1 (packed head-major attention) and K1b (attention on (B, H, S, D)):
the port against mickey_tpu.

On the CPU the port's wrappers take their plain versions; they are held
against the JAX Pallas kernels run in interpret mode on the sequence the JAX
backbone gives them (padded to a block multiple, padded keys masked), fp32,
at 1e-5. The CUDA kernels themselves are held against the plain versions on
the card (bf16 operands against fp32, |diff| < 2e-2), and K1b against K1,
which runs the same kernel body: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.ops.flash_attention import flash_attention as jax_flash
from mickey_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from mickey_tpu_torch.ops import _cuda
from mickey_tpu_torch.ops.flash_attention import (
    attention_packed_plain,
    attention_plain,
    flash_attention,
    flash_attention_packed,
    qkv_heads,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("heads,seq", [(2, 100), (6, 37)])
def test_plain_matches_jax_interpret(heads, seq):
    rng = np.random.default_rng(heads)
    qkv = rng.standard_normal((2, seq, 3 * heads * 64)).astype(np.float32)
    padded = np.pad(qkv, ((0, 0), (0, 128 - seq), (0, 0)))
    ref = jax_flash_packed(jnp.asarray(padded), seq, heads, block_q=128, block_k=128, interpret=True)
    out = flash_attention_packed(torch.from_numpy(qkv), heads)
    assert out.shape == (2, seq, heads * 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :seq], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads,seq", [(2, 100), (3, 37)])
def test_unpacked_plain_matches_jax_interpret(heads, seq):
    """K1b's plain version against the JAX kernel on a padded sequence: the
    real rows, and every row when the port is given the padded sequence
    with ``seq_len`` masking the rest."""
    rng = np.random.default_rng(10 + heads)
    q, k, v = (rng.standard_normal((2, heads, 128, 64)).astype(np.float32) for _ in range(3))
    q[:, :, seq:] = k[:, :, seq:] = v[:, :, seq:] = 0.0  # the JAX backbone's zero padding
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), seq, block_q=128, block_k=128, interpret=True))
    out = flash_attention(*(torch.from_numpy(x[:, :, :seq]) for x in (q, k, v)), seq)
    assert out.shape == (2, heads, seq, 64)
    np.testing.assert_allclose(out.numpy(), ref[:, :, :seq], rtol=1e-5, atol=1e-5)
    padded = flash_attention(*map(torch.from_numpy, (q, k, v)), seq)
    np.testing.assert_allclose(padded.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_unpacked_on_views_equals_packed():
    """The permuted views of a packed qkv (what the backbone hands K1b) give
    K1's result, and the same as contiguous copies of the views."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 45, 3 * 4 * 64)).astype(np.float32))
    q, k, v = qkv_heads(qkv, 4)
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, 45)
    torch.testing.assert_close(out, flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), 45),
                               rtol=0, atol=0)
    torch.testing.assert_close(out.transpose(1, 2).reshape(2, 45, 256), attention_packed_plain(qkv, 4),
                               rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_launches_nothing():
    before = dict(_cuda.LAUNCHES)
    flash_attention_packed(torch.zeros(1, 5, 3 * 64), 1)
    flash_attention(*(torch.zeros(1, 1, 5, 64) for _ in range(3)), 5)
    assert _cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [1939, 65, 64])
def test_kernel_matches_plain(cuda, seq):
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, seq, 3 * 16 * 64, device=cuda, generator=g).to(torch.bfloat16)
    out = flash_attention_packed(qkv, 16)
    ref = attention_packed_plain(qkv.float(), 16)
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() < 2e-2


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        flash_attention_packed(torch.zeros(1, 8, 3 * 64, device=cuda), 1)  # fp32
    with pytest.raises(ValueError):
        flash_attention_packed(torch.zeros(1, 8, 3 * 64, device=cuda, dtype=torch.bfloat16), 2)  # D = 32


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [1939, 65, 64])
def test_unpacked_kernel_matches_plain_and_packed(cuda, seq):
    """K1b on the strided views of a packed qkv: within the bf16 bound of its
    plain version, and bitwise K1's output (one kernel body)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, seq, 3 * 16 * 64, device=cuda, generator=g).to(torch.bfloat16)
    q, k, v = qkv_heads(qkv, 16)
    out = flash_attention(q, k, v, seq)
    ref = attention_plain(q.float(), k.float(), v.float(), seq)
    packed = flash_attention_packed(qkv, 16)
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() < 2e-2
    assert torch.equal(out.transpose(1, 2).reshape(2, seq, 16 * 64), packed)


@pytest.mark.cuda
def test_unpacked_kernel_masks_keys_past_seq_len(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(1, 2, 200, 64, device=cuda, generator=g).to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v, 130)
    ref = attention_plain(q.float(), k.float(), v.float(), 130)
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() < 2e-2


@pytest.mark.cuda
def test_unpacked_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention(x.float(), x, x, 8)
    with pytest.raises(ValueError):
        flash_attention(x, x, x, 9)  # seq_len > S
    with pytest.raises(ValueError):
        flash_attention(x[..., :32], x[..., :32], x[..., :32], 8)  # D = 32
    with pytest.raises(ValueError):
        flash_attention(x.transpose(2, 3).contiguous().transpose(2, 3), x, x, 8)  # D not unit-stride
