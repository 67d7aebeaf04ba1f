"""The ViT block's float passes (``ops/cuda/vit_passes.py``) on the CPU: the
plain versions equal the torch composition they stand for (the RoPE
rotation DINOv3's ``x cos + rotate_half(x) sin``), a trunk that
runs them gives the map of a trunk that runs its blocks as the port did
before the fused passes, bit for bit, and the kernels' wrappers refuse what
the kernels do not take. The kernels themselves are held to the plain
versions on the card (``tests/test_torch_cuda.py``)."""
import pytest
import torch
import torch.nn.functional as F

from pyvisim_tpu_torch import profiling
from pyvisim_tpu_torch.models import vit
from pyvisim_tpu_torch.ops.cuda import vit_passes

SIDE = 42  # a 3 x 3 patch grid, 10 tokens


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drawn(trunk: vit.ViTTrunk, seed: int) -> vit.ViTTrunk:
    """``trunk`` with parameters far from its initialisation (LayerScale
    U(0.2, 0.6), LayerNorm weights U(0.5, 1.5), biases N(0, 0.1)), so that
    every pass moves the map."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in trunk.named_parameters():
            if name.endswith("gamma"):
                t = 0.2 + 0.4 * torch.rand(p.shape, generator=g)
            elif name.endswith(("norm1.weight", "norm2.weight")):
                t = 0.5 + torch.rand(p.shape, generator=g)
            elif name.endswith("bias"):
                t = 0.1 * torch.randn(p.shape, generator=g)
            elif name.endswith("weight"):
                t = torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5
            else:
                t = 0.2 * torch.randn(p.shape, generator=g)
            p.copy_(t)
    return trunk


def _old_block(blk: vit.Block, t: torch.Tensor) -> torch.Tensor:
    """A block as the port ran it before the fused passes."""
    t = torch.addcmul(t, blk.attn(blk.norm1(t)), blk.ls1.gamma)
    z = blk.norm2(t)
    if isinstance(blk.mlp, vit.SwiGLUFFN):
        x1, x2 = blk.mlp.w12(z).chunk(2, dim=-1)
        y = blk.mlp.w3(F.silu(x1) * x2)
    else:
        y = blk.mlp(z)
    return torch.addcmul(t, y, blk.ls2.gamma)


def _old_forward(trunk: vit.ViTTrunk, x: torch.Tensor) -> torch.Tensor:
    """``ViTTrunk.forward`` before the fused passes: every block's own
    ``norm1``, the facet's ``norm1`` and linear over the patch rows alone."""
    b = x.shape[0]
    t = trunk.patch_embed.proj(x).flatten(2).transpose(1, 2)
    t = torch.cat([trunk.cls_token.expand(b, -1, -1), t], dim=1) + trunk.pos_embed
    for blk in trunk.blocks[:trunk.layer]:
        t = _old_block(blk, t)
    last = trunk.blocks[trunk.layer]
    if trunk.facet == "token":
        y = _old_block(last, t)[:, 1:]
    elif trunk.facet == "norm":
        y = trunk.norm(_old_block(last, t))[:, 1:]
    else:
        d, j = trunk.spec.embed_dim, vit.FACETS.index(trunk.facet)
        cols = slice(j * d, (j + 1) * d)
        y = F.linear(last.norm1(t[:, 1:]), last.attn.qkv.weight[cols], last.attn.qkv.bias[cols])
    return y.reshape(b, trunk.grid, trunk.grid, -1).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_plain_passes_equal_the_torch_composition(dtype):
    g = torch.Generator().manual_seed(1)
    x12 = (2.0 * torch.randn(3, 7, 2 * 40, generator=g)).to(dtype)
    want = F.silu(x12[..., :40]) * x12[..., 40:]
    assert torch.equal(vit_passes.swiglu_reference(x12), want)
    x, y = (torch.randn(3, 7, 48, generator=g).to(dtype) for _ in range(2))
    gamma, weight, bias = (torch.rand(48, generator=g).to(dtype) + 0.2 for _ in range(3))
    x_new, h = vit_passes.add_norm_reference(x, y, gamma, weight, bias, 1e-6)
    want_x = torch.addcmul(x, y, gamma)
    assert torch.equal(x_new, want_x)
    assert torch.equal(h, F.layer_norm(want_x, (48,), weight, bias, 1e-6))
    assert x_new.dtype == h.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("facet", vit.FACETS)
@pytest.mark.parametrize("ffn", ["swiglu", "mlp"])
def test_a_cpu_trunk_gives_the_old_block_composition_bit_for_bit(ffn, facet, dtype):
    spec = vit.ViTSpec(64, 3, 2, ffn, 96 if ffn == "swiglu" else 256)
    trunk = _drawn(vit.ViTTrunk(spec, layer=2, facet=facet, image_size=SIDE), 7).to(dtype)
    x = torch.rand(2, 3, SIDE, SIDE, generator=torch.Generator().manual_seed(2)).to(dtype)
    with torch.inference_mode(), profiling.record() as rec:
        got = trunk(x)
        want = _old_forward(trunk, x)
    assert got.shape == want.shape == (2, 64, 3, 3) and got.dtype == dtype
    assert torch.equal(got, want)
    # Blocks 0-1 whole: each an ls1 + norm2 and an ls2 + next norm1; the
    # token facet runs block 2 too, whose ls2 add is the trunk's last, and
    # the norm facet block 2 with its ls2 add and the final norm as one.
    whole = 3 if facet in ("token", "norm") else 2
    counts = {k: v for k, v in rec.counters().items() if k.startswith(("vit.swiglu", "vit.add"))}
    assert counts == {"vit.add_norm.plain": 2 * whole - (facet == "token"),
                      **({"vit.swiglu.plain": whole} if ffn == "swiglu" else {})}


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_plain_rotation_is_dinov3s_rope_in_float32(dtype):
    g = torch.Generator().manual_seed(3)
    b, n, prefix, heads, hd = 2, 11, 5, 3, 16
    qkv = (2.0 * torch.randn(b, n, 3 * heads * hd, generator=g)).to(dtype)
    angles = 7.0 * torch.rand(n - prefix, hd // 2, generator=g)
    table = torch.stack([angles.cos(), angles.sin()])
    before = qkv.clone()
    assert vit_passes.rope_reference(qkv, table) is qkv
    x = before[:, prefix:, :2 * heads * hd].float().unflatten(-1, (2 * heads, hd))
    cos, sin = table[0].tile(2)[:, None], table[1].tile(2)[:, None]
    rotate_half = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], dim=-1)
    want = before.clone()
    want[:, prefix:, :2 * heads * hd] = (x * cos + rotate_half * sin).flatten(-2).to(dtype)
    assert torch.equal(qkv, want)


_C = (_bf16(64),) * 3  # gamma, weight, bias
_T = torch.zeros(2, 3, 8)  # a RoPE table: 3 patches, half-heads of 8
REFUSED = {
    "swiglu-not-contiguous": (lambda: vit_passes.swiglu(_bf16(32, 4).t()), ValueError,
                              "contiguous"),
    "swiglu-halves-not-a-multiple-of-8": (lambda: vit_passes.swiglu(_bf16(4, 24)), ValueError,
                                          "multiple of 8"),
    "swiglu-float32": (lambda: vit_passes.swiglu(torch.zeros(4, 32)), TypeError, "bfloat16"),
    "swiglu-on-the-cpu": (lambda: vit_passes.swiglu(_bf16(4, 32)), ValueError, "CUDA"),
    "add-norm-not-contiguous": (lambda: vit_passes.add_norm(_bf16(64, 4).t(), _bf16(4, 64),
                                                            *_C, 1e-6), ValueError, "contiguous"),
    "add-norm-width-not-a-multiple-of-8": (
        lambda: vit_passes.add_norm(_bf16(4, 60), _bf16(4, 60), *(_bf16(60),) * 3, 1e-6),
        ValueError, "multiple of 8"),
    "add-norm-float32-gamma": (lambda: vit_passes.add_norm(_bf16(4, 64), _bf16(4, 64),
                                                           torch.zeros(64), *_C[1:], 1e-6),
                               TypeError, "bfloat16"),
    "add-norm-branch-of-another-shape": (lambda: vit_passes.add_norm(_bf16(4, 64), _bf16(5, 64),
                                                                     *_C, 1e-6),
                                         ValueError, "must be"),
    "add-norm-on-the-cpu": (lambda: vit_passes.add_norm(_bf16(4, 64), _bf16(4, 64), *_C, 1e-6),
                            ValueError, "CUDA"),
    "rope-float32-qkv": (lambda: vit_passes.rope(torch.zeros(2, 5, 96), _T), TypeError,
                         "bfloat16"),
    "rope-float64-table": (lambda: vit_passes.rope(_bf16(2, 5, 96), _T.double()), TypeError,
                           "float32"),
    "rope-not-contiguous": (lambda: vit_passes.rope(_bf16(5, 2, 96).transpose(0, 1), _T),
                            ValueError, "contiguous"),
    "rope-qkv-not-three-thirds": (lambda: vit_passes.rope(_bf16(2, 5, 95), _T), ValueError,
                                  "3C"),
    "rope-table-longer-than-the-tokens": (lambda: vit_passes.rope(_bf16(2, 2, 96), _T),
                                          ValueError, "P <="),
    "rope-half-head-not-a-multiple-of-8": (
        lambda: vit_passes.rope(_bf16(2, 5, 96), torch.zeros(2, 3, 4)), ValueError,
        "multiple of 8"),
    "rope-on-the-cpu": (lambda: vit_passes.rope(_bf16(2, 5, 96), _T), ValueError, "CUDA"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_kernel_wrappers_refuse_what_the_kernels_do_not_take(case):
    call, error, match = REFUSED[case]
    def launches():
        return vit_passes.swiglu.launches, vit_passes.add_norm.launches, vit_passes.rope.launches

    before = launches()
    with pytest.raises(error, match=match):
        call()
    assert launches() == before

