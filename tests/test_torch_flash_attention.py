"""K1 (packed head-major attention), K1b (attention on (B, H, S, D)) and
K1f (their fp32-operand counterparts, and the tools' K1-old): the port
against mickey_tpu.

On the CPU the port's wrappers take their plain versions; they are held
against the JAX Pallas kernels run in interpret mode on the sequence the JAX
backbone gives them (padded to a block multiple, padded keys masked), fp32,
at 1e-5 of the largest output. K1-old's plain version (bf16 in, fp32 math,
bf16 out) is held against JAX's ``attention_reference`` on the same bf16
input, K1-old's arithmetic (the tool's kernel body is local to its
``main()``), to one bf16 ulp. The CUDA kernels themselves are held against
the plain versions on the card: bf16 K1 / K1b at |diff| < 2e-2 (bf16
operands against fp32), K1f at 1e-5 of the largest output, K1-old to one
bf16 ulp; K1b against K1 and K1f strided against K1f packed, each pair one
kernel body: bitwise.

The bf16 kernel's arithmetic (key tiles, exp2 with a folded scale,
bf16-rounded probabilities) is repeated by ``attention_tiled_plain``, held
here against ``attention_plain`` and the JAX kernels in interpret mode; the
geometry of its TMA tensor maps (``map_geometry``) against numpy's strides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.ops.flash_attention import attention_reference
from mickey_tpu.ops.flash_attention import flash_attention as jax_flash
from mickey_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from mickey_tpu_torch.ops import _cuda
from mickey_tpu_torch.ops.flash_attention import (
    TMA_BOX_ROWS,
    attention_packed_plain,
    attention_plain,
    attention_tiled_plain,
    flash_attention,
    flash_attention_f32,
    flash_attention_packed,
    flash_attention_packed_f32,
    flash_attention_packed_upcast,
    map_geometry,
    packed_heads_layout,
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


ATTN_SEQS = [1939, 129, 128, 127, 65, 64, 1]  # whole key tiles, one key over, one under, a single key


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq", [(2, s) for s in ATTN_SEQS] + [(16, 129)])
def test_kernel_matches_plain(cuda, batch, seq):
    """K1 within the bf16 bound of its plain version, and two launches on the
    same input bitwise equal (a fixed summation order, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(batch, seq, 3 * 16 * 64, device=cuda, generator=g).to(torch.bfloat16)
    out = flash_attention_packed(qkv, 16)
    ref = attention_packed_plain(qkv.float(), 16)
    again = flash_attention_packed(qkv, 16)
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() < 2e-2
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        flash_attention_packed(torch.zeros(1, 8, 3 * 64, device=cuda, dtype=torch.float16), 1)  # neither bf16 nor fp32
    with pytest.raises(ValueError):
        flash_attention_packed(torch.zeros(1, 8, 3 * 64, device=cuda, dtype=torch.bfloat16), 2)  # D = 32


@pytest.mark.cuda
@pytest.mark.parametrize("seq", ATTN_SEQS)
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
    assert torch.equal(flash_attention(q, k, v, seq), out)


@pytest.mark.cuda
@pytest.mark.parametrize("s,seq_len", [(200, 130), (2048, 1939), (256, 128), (64, 1)])
def test_unpacked_kernel_masks_keys_past_seq_len(cuda, s, seq_len):
    """``seq_len`` < S: every query row is computed, the keys from
    ``seq_len`` on are masked and their tiles never loaded."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(1, 2, s, 64, device=cuda, generator=g).to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v, seq_len)
    ref = attention_plain(q.float(), k.float(), v.float(), seq_len)
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() < 2e-2


@pytest.mark.cuda
def test_unpacked_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention(x.float(), x, x, 8)  # fp32 q goes to K1f, which takes k and v in fp32 too
    with pytest.raises(TypeError):
        flash_attention(x.half(), x.half(), x.half(), 8)
    with pytest.raises(ValueError):
        flash_attention(x, x, x, 9)  # seq_len > S
    with pytest.raises(ValueError):
        flash_attention(x[..., :32], x[..., :32], x[..., :32], 8)  # D = 32
    with pytest.raises(ValueError):
        flash_attention(x.transpose(2, 3).contiguous().transpose(2, 3), x, x, 8)  # D not unit-stride


TILED_CASES = [(100, 100, 64), (37, 37, 64), (128, 100, 64), (192, 65, 128), (64, 1, 64)]  # (S, seq_len, block_k)


def _tiled_inputs(s, seed, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((2, 3, s, 64)).astype(np.float32)).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("s,seq_len,block_k", TILED_CASES)
def test_tiled_plain_matches_plain_bf16(s, seq_len, block_k):
    """The kernel's arithmetic on bf16 inputs (probabilities rounded to
    bf16) against the fp32 plain version of the same values: the kernels'
    bound, 2e-2 on O(1) outputs."""
    q, k, v = _tiled_inputs(s, 40 + s, torch.bfloat16)
    out = attention_tiled_plain(q, k, v, seq_len, block_k)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, s, 64)
    ref = attention_plain(q.float(), k.float(), v.float(), seq_len)
    assert (out.float() - ref).abs().max().item() < 2e-2


@pytest.mark.parametrize("s,seq_len,block_k", TILED_CASES)
def test_tiled_plain_matches_plain_fp32(s, seq_len, block_k):
    """On fp32 inputs nothing is rounded, so the tiles, the exp2 domain and
    the folded scale alone move the result: 1e-5 of the largest output."""
    q, k, v = _tiled_inputs(s, 50 + s, torch.float32)
    out = attention_tiled_plain(q, k, v, seq_len, block_k)
    ref = attention_plain(q, k, v, seq_len)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("s,seq_len,block_k", TILED_CASES)
def test_tiled_plain_matches_jax_interpret(s, seq_len, block_k):
    """Against the JAX kernels in interpret mode on the same bf16 values,
    with the same key tile: K1b on (B, H, S, D) padded to a tile multiple
    (every row of the padded sequence), and K1 on the packed layout. Both
    round the probabilities to bf16; exp against exp2 and the bf16 output
    rounding remain: 2e-2."""
    q, k, v = _tiled_inputs(s, 60 + s, torch.bfloat16)
    pad = -s % block_k
    qp, kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    out = attention_tiled_plain(qp, kp, vp, seq_len, block_k).float().numpy()
    as_jax = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    ref = jax_flash(as_jax(qp), as_jax(kp), as_jax(vp), seq_len, block_q=block_k, block_k=block_k, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(out - ref).max() < 2e-2
    packed = torch.stack([qp, kp, vp], dim=3).permute(0, 2, 1, 3, 4).reshape(2, s + pad, 3 * 3 * 64)  # (B, S, H, 3, D)
    ref_p = jax_flash_packed(as_jax(packed), seq_len, 3, block_q=block_k, block_k=block_k, interpret=True)
    ref_p = np.asarray(ref_p.astype(jnp.float32)).reshape(2, s + pad, 3, 64).transpose(0, 2, 1, 3)
    assert np.abs(out - ref_p).max() < 2e-2


def _geometry(t: torch.Tensor):
    return map_geometry(tuple(t.shape), t.stride(), t.element_size())


@pytest.mark.parametrize("b,s,heads", [(2, 37, 4), (1, 64, 1), (4, 1939, 16)])
def test_map_geometry_of_packed_layout_matches_numpy(b, s, heads):
    """The tensor maps of q, k and v of a packed qkv: dims innermost first,
    byte strides equal to numpy's for the same views, bases 128 bytes apart,
    and ``packed_heads_layout`` equal to what ``qkv_heads`` gives."""
    qkv = np.zeros((b, s, 3 * heads * 64), np.float16)  # two bytes an element, as bf16
    views = [qkv.reshape(b, s, heads, 3, 64)[:, :, :, i].transpose(0, 2, 1, 3) for i in range(3)]
    t_views = qkv_heads(torch.from_numpy(qkv), heads)
    shape, strides, offsets = packed_heads_layout(b, s, heads)
    for view, t, off in zip(views, t_views, offsets):
        assert tuple(t.shape) == shape and (t.stride() == strides or 1 in shape[:3])
        assert t.data_ptr() - t_views[0].data_ptr() == 2 * off
        dims, byte_strides, box = _geometry(t)
        assert (dims, box) == ((64, s, heads, b), (64, TMA_BOX_ROWS, 1, 1))
        assert map_geometry(shape, strides, 2) == (dims, byte_strides, box)
        want = (view.strides[2], view.strides[1], view.strides[0])
        for size, got, ref in zip((s, heads, b), byte_strides, want):
            assert got == ref or size == 1  # a size-1 dimension takes the dense stride
    if heads > 1 and b > 1:
        assert byte_strides == (3 * heads * 128, 3 * 128, s * 3 * heads * 128)


def test_map_geometry_of_contiguous_and_sliced_views():
    x = torch.zeros(2, 3, 80, 64, dtype=torch.bfloat16)
    assert map_geometry(tuple(x.shape), x.stride(), 2) == ((64, 80, 3, 2), (128, 80 * 128, 3 * 80 * 128), (64, 64, 1, 1))
    sliced = x[:, :, :50]  # the sequence cut short: the strides stay, S shrinks
    assert _geometry(sliced) == ((64, 50, 3, 2), (128, 80 * 128, 3 * 80 * 128), (64, 64, 1, 1))
    one = torch.zeros(1, 1, 5, 64, dtype=torch.bfloat16)  # size-1 dimensions: dense strides
    assert _geometry(one)[1] == (128, 5 * 128, 5 * 128)


def test_map_geometry_refuses_what_tma_does_not_take():
    with pytest.raises(ValueError):  # a row stride of 68 elements is 136 bytes
        map_geometry((1, 2, 8, 64), (2 * 8 * 68, 8 * 68, 68, 1), 2)
    with pytest.raises(ValueError):  # D not unit-stride
        map_geometry((1, 2, 8, 64), (1024, 512, 1, 8), 2)
    x = torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16)[..., :64]  # the same, from a sliced tensor
    with pytest.raises(ValueError):
        _geometry(x)


def _bf16_close(out: np.ndarray, ref: np.ndarray) -> bool:
    """Two bf16 roundings of fp32 results that agree to 1e-5 max|ref|: one
    bf16 ulp at the larger of the two (2^(e-8) for |x| in [2^(e-1), 2^e)),
    plus 1e-5 max|ref| (near zero the ulp is below the fp32 difference)."""
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(out), np.abs(ref)))[1] - 8)
    return bool((np.abs(out - ref) <= ulp + 1e-5 * np.abs(ref).max()).all())


@pytest.mark.parametrize("heads,seq,padded", [(2, 100, 128), (3, 37, 64)])
def test_fp32_plain_matches_jax_interpret_on_padded_input(heads, seq, padded):
    """K1f's packed and strided plain versions, given the padded sequence
    with ``seq_len`` < S, against the JAX kernels in interpret mode on fp32
    input: every row, padded ones included, at 1e-5 of the largest output;
    and the packed entry on the unpadded sequence, on the real rows."""
    rng = np.random.default_rng(20 + heads)
    qkv = rng.standard_normal((2, padded, 3 * heads * 64)).astype(np.float32)
    qkv[:, seq:] = 0.0  # the JAX backbone's zero padding
    ref = np.asarray(jax_flash_packed(jnp.asarray(qkv), seq, heads, block_q=padded, block_k=padded, interpret=True))
    tol = 1e-5 * np.abs(ref).max()
    out = attention_packed_plain(torch.from_numpy(qkv), heads, seq).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    real = flash_attention_packed_f32(torch.from_numpy(qkv[:, :seq]), heads).numpy()
    np.testing.assert_allclose(real, ref[:, :seq], rtol=0, atol=tol)
    q, k, v = (np.ascontiguousarray(x) for x in qkv_heads(torch.from_numpy(qkv), heads))
    ref_u = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), seq, block_q=padded, block_k=padded, interpret=True))
    out_u = flash_attention_f32(*(torch.from_numpy(x) for x in (q, k, v)), seq).numpy()
    np.testing.assert_allclose(out_u, ref_u, rtol=0, atol=1e-5 * np.abs(ref_u).max())


def test_upcast_plain_matches_jax_reference():
    """K1-old's plain version on bf16 packed input with keys past ``seq_len``
    masked, against ``attention_reference`` (upcast, fp32 math, bf16 out) on
    the same views: within one bf16 ulp (``_bf16_close``), on every row."""
    rng = np.random.default_rng(30)
    heads, seq, s = 4, 150, 192
    qkv = torch.from_numpy(0.05 * rng.standard_normal((2, s, 3 * heads * 64)).astype(np.float32)).to(torch.bfloat16)
    out = flash_attention_packed_upcast(qkv, heads, seq)
    assert out.dtype == torch.bfloat16 and out.shape == (2, s, heads * 64)
    views = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in qkv_heads(qkv, heads)]
    ref = np.asarray(attention_reference(*views, seq).astype(jnp.float32))
    ref = ref.transpose(0, 2, 1, 3).reshape(2, s, heads * 64)
    assert _bf16_close(out.float().numpy(), ref)


def test_fp32_cpu_wrappers_launch_nothing():
    before = dict(_cuda.LAUNCHES)
    flash_attention_packed(torch.zeros(1, 5, 3 * 64), 1)  # fp32 on the CPU: the plain version, not K1f
    flash_attention_packed_f32(torch.zeros(1, 5, 3 * 64), 1)
    flash_attention_f32(*(torch.zeros(1, 1, 5, 64) for _ in range(3)), 5)
    flash_attention_packed_upcast(torch.zeros(1, 8, 3 * 64, dtype=torch.bfloat16), 1, 5)
    assert _cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [1939, 65, 64])
def test_f32_kernels_match_plain(cuda, seq):
    """K1f packed and strided on fp32 (the ``FLOAT16=False`` backbone's
    input), dispatched from the bf16 entries by dtype: 1e-5 of the largest
    output against the plain versions; strided bitwise packed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, seq, 3 * 16 * 64, device=cuda, generator=g)
    before = dict(_cuda.LAUNCHES)
    out = flash_attention_packed(qkv, 16)
    views = qkv_heads(qkv, 16)
    out_u = flash_attention(*views, seq)
    ref = attention_packed_plain(qkv, 16)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention_packed_f32"] == before["flash_attention_packed_f32"] + 1
    assert _cuda.LAUNCHES["flash_attention_f32"] == before["flash_attention_f32"] + 1
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.equal(out_u.transpose(1, 2).reshape(2, seq, 16 * 64), out)


@pytest.mark.cuda
def test_upcast_kernel_matches_plain(cuda):
    """K1-old's counterpart at the tool's layout (S padded to 2048 here cut to
    256, ``seq_len`` masking the tail): rows below ``seq_len`` within one
    bf16 ulp of the plain version's rounded output."""
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = (0.05 * torch.randn(2, 256, 3 * 16 * 64, device=cuda, generator=g)).to(torch.bfloat16)
    out = flash_attention_packed_upcast(qkv, 16, 200)[:, :200].float().cpu().numpy()
    ref = attention_packed_plain(qkv, 16, 200)[:, :200].float().cpu().numpy()
    assert _bf16_close(out, ref)


@pytest.mark.cuda
def test_f32_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention_f32(x, x.to(torch.bfloat16), x, 8)
    with pytest.raises(ValueError):
        flash_attention_f32(x[..., :32], x[..., :32], x[..., :32], 8)  # D = 32
    with pytest.raises(ValueError):
        flash_attention_f32(x.transpose(2, 3).contiguous().transpose(2, 3), x, x, 8)  # D not unit-stride
    with pytest.raises(TypeError):
        flash_attention_packed_upcast(torch.zeros(1, 8, 3 * 64, device=cuda), 1, 8)  # fp32 input
    with pytest.raises(ValueError):
        flash_attention_packed_upcast(torch.zeros(1, 8, 3 * 64, device=cuda, dtype=torch.bfloat16), 1, 9)
