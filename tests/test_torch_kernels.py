"""The port's standalone kernels (``repro_torch.kernels``) against the JAX
package's (``repro.kernels``) on the CPU, where each wrapper runs its
plain PyTorch version: every case of ``tests/test_kernels.py`` at its
tolerance (1e-4 / 2e-2 matmul, 1e-5 / 3e-2 rmsnorm, 2e-5 / 3e-2 flash
attention, f32 / bf16), the reference's kernels in interpret mode, the
four oracles of ``ref.py``, and the API: the blocks' clamp, the shapes
that raise, the output types, a device with no kernel, and an import that
builds nothing.  The inputs are seeded numpy arrays; a bf16 input is one
f32 array cast by each framework, and the two casts agree bit for bit."""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

#: tests/test_kernels.py's tolerances, rtol = atol, by kernel and type
TOL = {"matmul": {"float32": 1e-4, "bfloat16": 2e-2},
       "rmsnorm": {"float32": 1e-5, "bfloat16": 3e-2},
       "flash_attention": {"float32": 2e-5, "bfloat16": 3e-2}}


def _inputs(dtype, *shapes, seed=0):
    """Seeded f32 normals as (jax, torch) pairs of ``dtype``; a bf16 pair
    is each framework's cast of the same f32 array, checked bitwise."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        arr = rng.standard_normal(shape).astype(np.float32)
        j, t = jnp.asarray(arr), torch.from_numpy(arr)
        if dtype == "bfloat16":
            j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
            assert np.array_equal(np.asarray(j).view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))
        out.append((j, t))
    return out


def _close(want, got, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 512, 256), (384, 128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_jax(m, k, n, dtype):
    (aj, at), (bj, bt) = _inputs(dtype, (m, k), (k, n))
    out = tk.matmul(at, bt)
    assert out.dtype == at.dtype and out.shape == (m, n)
    tol = TOL["matmul"][dtype]
    _close(jk.matmul(aj, bj), out, tol)
    _close(jref.matmul_ref(aj, bj), out, tol)


@pytest.mark.parametrize("rows,d", [(128, 256), (256, 512), (384, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(rows, d, dtype):
    (xj, xt), (wj, wt) = _inputs(dtype, (rows, d), (d,))
    out = tk.rmsnorm(xt, wt)
    assert out.dtype == xt.dtype and out.shape == (rows, d)
    tol = TOL["rmsnorm"][dtype]
    _close(jk.rmsnorm(xj, wj), out, tol)
    _close(jref.rmsnorm_ref(xj, wj), out, tol)


@pytest.mark.parametrize("s,h,hd,bq,bk", [
    (128, 2, 64, 64, 64), (256, 4, 64, 128, 64), (128, 2, 128, 64, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(s, h, hd, bq, bk, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(dtype, *[(2, s, h, hd)] * 3)
    out = tk.flash_attention(qt, kt, vt, bq=bq, bk=bk)
    assert out.dtype == qt.dtype and out.shape == (2, s, h, hd)
    tol = TOL["flash_attention"][dtype]
    _close(jk.flash_attention(qj, kj, vj, bq=bq, bk=bk), out, tol)
    _close(jref.flash_attention_ref(qj, kj, vj), out, tol)


def test_flash_attention_noncausal_matches_jax():
    (qj, qt), (kj, kt), (vj, vt) = _inputs("float32", *[(1, 128, 2, 64)] * 3)
    out = tk.flash_attention(qt, kt, vt, bq=64, bk=64, causal=False)
    _close(jk.flash_attention(qj, kj, vj, bq=64, bk=64, causal=False), out,
           2e-5)
    _close(jref.flash_attention_ref(qj, kj, vj, causal=False), out, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_oracles_match_jax(dtype):
    """matmul_ref, rmsnorm_ref and flash_attention_ref (causal and not):
    the torch oracles within 1e-5 of the JAX ones in f32 (both sum in f32,
    in other orders), within one bf16 rounding (2e-2) in bf16."""
    tol = 1e-5 if dtype == "float32" else 2e-2
    (aj, at), (bj, bt) = _inputs(dtype, (64, 96), (96, 32))
    _close(jref.matmul_ref(aj, bj), tref.matmul_ref(at, bt), tol)
    (xj, xt), (wj, wt) = _inputs(dtype, (16, 96), (96,), seed=1)
    _close(jref.rmsnorm_ref(xj, wj, 1e-5), tref.rmsnorm_ref(xt, wt, 1e-5),
           tol)
    qkv = _inputs(dtype, *[(2, 48, 3, 32)] * 3, seed=2)
    for causal in (True, False):
        _close(jref.flash_attention_ref(*(j for j, _ in qkv), causal=causal),
               tref.flash_attention_ref(*(t for _, t in qkv),
                                        causal=causal), tol)


@pytest.mark.parametrize("hd", [32, 96, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_padded_widths_match_jax(hd, dtype):
    """The widths the CUDA kernel pads (32 and 96 into its 64- and
    128-wide builds) and gemma-7b's 256: the plain version against the
    reference's kernel (interpret mode) and oracle, causal, at the
    reference's tolerances (tests/test_kernels.py:52)."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(dtype, *[(2, 128, 2, hd)] * 3,
                                           seed=hd)
    out = tk.flash_attention(qt, kt, vt, bq=64, bk=64)
    assert out.dtype == qt.dtype and out.shape == (2, 128, 2, hd)
    tol = TOL["flash_attention"][dtype]
    _close(jk.flash_attention(qj, kj, vj, bq=64, bk=64), out, tol)
    _close(jref.flash_attention_ref(qj, kj, vj), out, tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [320, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_wide_heads_match_jax(hd, dtype, causal):
    """Heads wider than 256 (the CUDA kernel's wide path on the card):
    the wrapper admits them and, on the CPU, runs the plain version, held
    to the reference's kernel (interpret mode) and oracle at the
    reference's tolerances, at a small S."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(dtype, *[(1, 64, 2, hd)] * 3,
                                           seed=hd + causal)
    out = tk.flash_attention(qt, kt, vt, bq=32, bk=32, causal=causal)
    assert out.dtype == qt.dtype and out.shape == (1, 64, 2, hd)
    tol = TOL["flash_attention"][dtype]
    _close(jk.flash_attention(qj, kj, vj, bq=32, bk=32, causal=causal), out,
           tol)
    _close(jref.flash_attention_ref(qj, kj, vj, causal=causal), out, tol)


#: chip_smoke.py's and tests/test_torch_gpu.py's bf16 flash tolerance
#: against the plain version: rtol, atol, and the share of outputs whose
#: bits may differ
BF16_FLASH_TOL, BF16_DIFFER = (8e-3, 1e-4), 0.01


def _flash_bf16_emulated(q, k, v, split, bk=64):
    """The bf16 CUDA kernel's arithmetic in torch (hd=128: 64-key
    tiles): bf16 operands, Q K^T with exact products summed in f32 and
    scaled after the product, the online softmax in f32 on logits in
    log2 units, P fed to the P V product as bf16 hi + lo (``split``) or
    rounded to bf16, the sums in f32."""
    b, s, h, hd = q.shape
    qf, kf, vf = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    scale = 1.0 / hd ** 0.5 * 1.4426950408889634
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, hd))
    pos = torch.arange(s)
    for k0 in range(0, s, bk):
        x = (qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
        x = x.masked_fill(pos[k0:k0 + bk][None, :] > pos[:, None], -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp2(x - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        vt = vf[:, :, k0:k0 + bk]
        pv = hi @ vt + ((p - hi).bfloat16().float() @ vt if split else 0)
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp(min=1e-30)).permute(0, 2, 1, 3).bfloat16()


def test_bf16_flash_kernel_arithmetic_needs_p_split():
    """S=1024, H=4, hd=128, causal: with P split into bf16 hi + lo the
    kernel's arithmetic stays within the gpu tests' bf16 tolerance of the
    plain version with at most 1 % of the outputs' bits differing; with P
    rounded to bf16 it does not (the reason the kernel runs the P V
    product twice)."""
    (_, q), (_, k), (_, v) = _inputs("bfloat16", *[(1, 1024, 4, 128)] * 3,
                                     seed=3)
    want = tk.flash_attention_plain(q, k, v)
    got = _flash_bf16_emulated(q, k, v, split=True)
    rtol, atol = BF16_FLASH_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert float((got != want).float().mean()) <= BF16_DIFFER
    rounded = _flash_bf16_emulated(q, k, v, split=False)
    assert float((rounded != want).float().mean()) > 10 * BF16_DIFFER


def test_tma_ready_copies_only_refused_layouts():
    """``tma_ready`` returns an operand the kernels can copy as it lies
    (unit inner stride, other strides multiples of 16 bytes) unchanged,
    and copies any other into rows padded to 16 bytes: the same values,
    so the plain versions give bitwise the same outputs on the copies.
    The layouts are (130, 17) x (17, 257) operands (34- and 514-byte bf16
    rows), a transposed operand, and a 33-wide head."""
    rng = np.random.default_rng(7)
    for dt in (torch.float32, torch.bfloat16):
        a = torch.from_numpy(rng.standard_normal((130, 17), np.float32))
        b = torch.from_numpy(rng.standard_normal((17, 257), np.float32))
        a, b = a.to(dt), b.to(dt)
        ok = torch.zeros(64, 128, dtype=dt)
        assert tbuild.tma_ready(ok) is ok
        for t in (a, b, b.T.contiguous().T):
            r = tbuild.tma_ready(t)
            assert r is not t and torch.equal(r, t)
            assert r.stride(-1) == 1
            assert all(st * r.element_size() % 16 == 0
                       for st in r.stride()[:-1])
        assert torch.equal(tk.matmul_plain(tbuild.tma_ready(a),
                                           tbuild.tma_ready(b), bm=130,
                                           bn=257),
                           tk.matmul_plain(a, b, bm=130, bn=257))
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, 3, 64, 33), np.float32)).to(dt).transpose(1, 2)
            for _ in range(3))
        ready = [tbuild.tma_ready(t) for t in (q, k, v)]
        assert all(r is not t and torch.equal(r, t)
                   for r, t in zip(ready, (q, k, v)))
        assert torch.equal(tk.flash_attention_plain(*ready, bq=64, bk=64),
                           tk.flash_attention_plain(q, k, v, bq=64, bk=64))
        bhsd = torch.zeros(2, 3, 64, 64, dtype=dt).transpose(1, 2)
        assert tbuild.tma_ready(bhsd) is bhsd


def test_matmul_plan_fills_the_sms():
    """The launch plan at deepseek-7b's (256, 4096) x (4096, 11008) on an
    H100's 132 SMs: bf16 in 128 x 192 tiles (116 tiles, one wave; 128
    take two waves), f32 in 128 x 128 tiles
    with K split 3 ways (516 units, 3.9 an SM, against 1.3 tiles an SM
    in two rounds unsplit); a split never gets less than one 32-deep
    slab."""
    from repro_torch.kernels.matmul import plan
    assert plan(256, 11008, 4096, 1, 132) == (192, 1)
    assert plan(256, 11008, 4096, 0, 132) == (0, 3)
    assert plan(130, 257, 17, 0, 132) == (0, 1)
    assert plan(4096, 4096, 4096, 1, 132) == (128, 1)
    assert {plan(m, n, 4096, 1, 132)[0] for m in (1, 256, 4096)
            for n in (64, 11008, 4096)} <= {128, 192}   # the built widths
    for m, n, k in [(1, 3, 4096), (128, 128, 128), (100, 72, 60)]:
        bn, splits = plan(m, n, k, 0, 132)
        assert 1 <= splits <= -(-k // 32)


def test_ref_decode_attention_gqa_matches_jax():
    """decode_attention_ref with 8 query heads over 2 KV heads and ragged
    lengths (one of them 1, one the whole cache)."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs("float32", (3, 8, 64),
                                           (3, 20, 2, 64), (3, 20, 2, 64))
    lens = np.array([5, 20, 1], np.int32)
    got = tref.decode_attention_ref(qt, kt, vt, torch.from_numpy(lens))
    assert got.shape == (3, 8, 64)
    _close(jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lens)), got,
           1e-5)


def test_blocks_clamp_to_the_dimension():
    """Blocks larger than a dimension are clamped to it, as the reference
    does: shapes that are no multiple of 128 run with the default blocks
    and agree with the reference's kernels."""
    (aj, at), (bj, bt) = _inputs("float32", (100, 60), (60, 72))
    _close(jk.matmul(aj, bj), tk.matmul(at, bt), 1e-4)
    (xj, xt), (wj, wt) = _inputs("float32", (96, 40), (40,))
    _close(jk.rmsnorm(xj, wj), tk.rmsnorm(xt, wt), 1e-5)
    (qj, qt), (kj, kt), (vj, vt) = _inputs("float32", *[(1, 96, 2, 64)] * 3)
    _close(jk.flash_attention(qj, kj, vj), tk.flash_attention(qt, kt, vt),
           2e-5)


def test_bad_shapes_raise():
    """The reference's asserts are ValueErrors, raised before anything
    runs: mismatched operands, blocks that do not divide, empty inputs."""
    z = lambda *shape: torch.zeros(shape)
    cases = [
        lambda: tk.matmul(z(128, 64), z(32, 128)),
        lambda: tk.matmul(z(192, 64), z(64, 128)),          # bm=128 ∤ 192
        lambda: tk.matmul(z(128, 64), z(64, 128), bk=48),
        lambda: tk.matmul(z(128), z(128, 4)),
        lambda: tk.matmul(z(0, 64), z(64, 128)),
        lambda: tk.rmsnorm(z(128, 64), z(32)),
        lambda: tk.rmsnorm(z(192, 64), z(64)),              # 128 ∤ 192
        lambda: tk.rmsnorm(z(128, 64), z(64), block_rows=0),
        lambda: tk.flash_attention(z(1, 192, 2, 64), z(1, 192, 2, 64),
                                   z(1, 192, 2, 64)),       # bq=128 ∤ 192
        lambda: tk.flash_attention(z(1, 128, 2, 64), z(1, 128, 2, 64),
                                   z(1, 128, 2, 64), bk=96),
        lambda: tk.flash_attention(z(1, 128, 2, 64), z(1, 64, 2, 64),
                                   z(1, 128, 2, 64)),
        lambda: tk.flash_attention(z(128, 2, 64), z(128, 2, 64),
                                   z(128, 2, 64)),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case()
    for plain in (lambda: tk.matmul_plain(z(128, 64), z(32, 128)),
                  lambda: tk.rmsnorm_plain(z(192, 64), z(64)),
                  lambda: tk.flash_attention_plain(*[z(1, 192, 2, 64)] * 3)):
        with pytest.raises(ValueError):
            plain()
    assert not any(tk.launch_counts().values())


def test_device_without_a_kernel_raises():
    """A meta tensor (any device but the CPU and the card) raises; so do
    inputs on two devices."""
    m = lambda *shape: torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.matmul(m(128, 128), m(128, 128))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.rmsnorm(m(128, 64), m(64))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.flash_attention(m(1, 64, 2, 64), m(1, 64, 2, 64),
                           m(1, 64, 2, 64))
    with pytest.raises(ValueError, match="one device"):
        tk.rmsnorm(torch.zeros(128, 64), m(64))


def test_kernel_limits_and_launch_counts():
    """The CUDA kernels take float32 or bfloat16 inputs of one type (other
    types raise NotImplementedError on the card); the CPU runs never
    count a launch."""
    tk.reset_launch_counts()
    x = torch.ones(4, 8)
    for bad in [(x.half(),), (x, x.double()), (x.bfloat16(), x)]:
        with pytest.raises(NotImplementedError):
            tbuild.dtype_code(*bad)
    assert tbuild.dtype_code(x, x) == 0
    assert tbuild.dtype_code(x.bfloat16()) == 1
    tk.matmul(x, x.T)
    tk.rmsnorm(x, x[0])
    tk.flash_attention(*[torch.ones(1, 4, 1, 8)] * 3)
    assert tk.launch_counts() == {"matmul": 0, "rmsnorm": 0,
                                  "flash_attention": 0}


_NO_BUILD = r"""
import subprocess, sys
def refuse(*a, **k):
    raise AssertionError("a subprocess ran: " + repr(a[:1]))
subprocess.Popen = subprocess.run = refuse
import torch
import repro_torch.kernels as tk
from repro_torch.kernels import build
x = torch.ones(8, 8)
tk.matmul(x, x); tk.rmsnorm(x, x[0])
tk.flash_attention(*[torch.ones(1, 8, 1, 8)] * 3)
assert build._LIB is None
assert not any(m.startswith("repro_torch.megakernel") for m in sys.modules)
print("OK")
"""


def test_import_and_cpu_calls_build_nothing():
    """Importing ``repro_torch.kernels`` and running it on the CPU starts
    no process (no nvcc) and loads no library."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _NO_BUILD], env=env,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "OK"


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: fails on request, else writes the -o file
if [ -n "$FAKE_NVCC_FAIL" ]; then echo "fake nvcc: error in $@" >&2; exit 2; fi
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi
  shift
done
"""


def test_build_names_each_source_by_its_hash(tmp_path, monkeypatch):
    """The standalone source builds into its own library,
    ``libstandalone_<hash>.so``, beside the megakernel's
    ``libmegakernel_<hash>.so`` (its name and flags unchanged: the hash
    of the source and the flags), each cached once built; a compiler
    failure raises with the compiler's output and leaves no library."""
    import hashlib

    from repro_torch.megakernel import build as mbuild
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(mbuild, "BUILD_DIR", tmp_path / "build")
    assert mbuild.NVCC_FLAGS[:2] == ("-gencode",
                                     "arch=compute_90a,code=sm_90a")
    for build, src, stem in ((mbuild.build_library, mbuild.SOURCE,
                              "megakernel"),
                             (tbuild.build_library, tbuild.SOURCE,
                              "standalone")):
        key = hashlib.sha1(src.read_bytes() + " ".join(
            mbuild.NVCC_FLAGS).encode()).hexdigest()[:16]
        path, log = build()
        assert path == tmp_path / "build" / f"lib{stem}_{key}.so"
        assert path.read_text() == "built\n" and log != "cached"
        assert build() == (path, "cached")
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    monkeypatch.setattr(mbuild, "BUILD_DIR", tmp_path / "fail")
    with pytest.raises(RuntimeError, match="fake nvcc: error in"):
        tbuild.build_library()
    assert not any((tmp_path / "fail").glob("*.so"))
