#!/usr/bin/env python3
"""Write a copy of a checkout's megakernel with a per-task
``%globaltimer`` stamp, for ``tools/ab_megakernel.py``.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 tools/prefetch_variants.py build/variants --stamp . build/parent
    python3 tools/ab_megakernel.py build/parent build/variants/*

``--stamp ROOT`` writes ``stamp-<name of ROOT>`` (``stamp-change`` for the
checkout), a copy of ROOT's package whose static kernel records, for
every task row (indexed by grid slot, 8 words a slot), with thread 0's
``%globaltimer``: 0 the wait's start, 1 its end, 2 the primary tile in
place (the task's start after its barrier; a matmul's or expert GEMM's x
rows in shared memory where the kernel stages them), 3 its first weight
bytes returned (thread 0 loads the first weight float4 and stores it
into word 6, so that the next stamp issues after the load has returned;
with the weight ring: the first stage full), 4 the end of thread 0's
share of the weight stream (the ring: the end of the first row pass's
last column pass), 5 the task's stores landed (the barrier before the
signal).  The copy's library exports ``mk_set_stamp(pointer)`` (null:
off), which ``tools/ab_megakernel.py`` uses.  Each edit asserts that the
text it replaces appears exactly once.  Imports nothing of JAX or of the
port.
"""
import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("repro_torch") / "megakernel" / "csrc" / "megakernel.cu"

STAMP_FNS = '''// The stamp buffer (null: off) and the running row's grid slot, kept in
// the block-reduction words past those block_sum uses; the timer read is
// a compiler memory barrier, so that no load moves across a stamp.
__device__ unsigned long long* g_stamp = nullptr;

__device__ __forceinline__ unsigned long long stamp_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}

__device__ __forceinline__ void set_slot(const Smem& sm, long long slot) {
  *reinterpret_cast<long long*>(sm.scal + 20) = slot;
}

__device__ __forceinline__ void stamp(const Smem& sm, int k) {
  const long long slot = *reinterpret_cast<const long long*>(sm.scal + 20);
  if (g_stamp != nullptr && slot >= 0) g_stamp[slot * 8 + k] = stamp_ns();
}

// Store a loaded word into the slot's word 6: the store waits for the
// load, and the stamp after it issues after the store.
__device__ __forceinline__ void stamp_sink(const Smem& sm, float v) {
  const long long slot = *reinterpret_cast<const long long*>(sm.scal + 20);
  if (g_stamp != nullptr && slot >= 0)
    g_stamp[slot * 8 + 6] = __float_as_uint(v);
}

'''

#: (old, new): the old text must appear exactly once
STAMP_EDITS = [
    ("// ---- kind 1: out[m, ws] = act(x[m, K] @ W[K, ws] + bias)",
     STAMP_FNS + "// ---- kind 1: out[m, ws] = act(x[m, K] @ W[K, ws] + bias)"),
    ("    bool live[CPT];\n",
     "    if (threadIdx.x == 0 && r0 == 0 && !MUL_OUT) {\n"
     "      stamp(sm, 2);\n"
     "      stamp_sink(sm, __ldg(wp).x);\n"
     "      stamp(sm, 3);\n"
     "    }\n"
     "    bool live[CPT];\n"),
    ("  if (nks > 1) {                        // then CPT == 1: reduce K "
     "slices\n",
     "  if (threadIdx.x == 0 && !MUL_OUT) stamp(sm, 4);\n"
     "  if (nks > 1) {                        // then CPT == 1: reduce K "
     "slices\n"),
    ("          if (d[32] >= 0) wait_event(heap, S, wk.w, row, d[32], d[33], "
     "c);\n",
     "          set_slot(sm, row);\n"
     "          stamp(sm, 0);\n"
     "          if (d[32] >= 0) wait_event(heap, S, wk.w, row, d[32], d[33], "
     "c);\n"),
    ("          if (S.tr_off >= 0) t_start = atomicAdd(heap + S.tr_off, "
     "1.0f);\n",
     "          stamp(sm, 1);\n"
     "          if (S.tr_off >= 0) t_start = atomicAdd(heap + S.tr_off, "
     "1.0f);\n"),
    ("    run_task<EXT>(d[0], heap, d, S, sm);\n",
     "    if (threadIdx.x == 0) stamp(sm, 2);\n"
     "    run_task<EXT>(d[0], heap, d, S, sm);\n"),
    ("    __syncthreads();                    // the task's stores landed\n"
     "    if (threadIdx.x == 0) {\n",
     "    __syncthreads();                    // the task's stores landed\n"
     "    if (threadIdx.x == 0) {\n"
     "      stamp(sm, 5);\n"),
    ("  const long long w = blockIdx.x;\n",
     "  const long long w = blockIdx.x;\n"
     "  if (threadIdx.x == 0) set_slot(sm, -1);\n"),
    ('extern "C" const char* mk_error_string(int err) {',
     '// Point the stamp buffer at `p` (null: off).\n'
     'extern "C" int mk_set_stamp(void* p) {\n'
     '  return static_cast<int>(cudaMemcpyToSymbol(g_stamp, &p, '
     'sizeof p));\n'
     '}\n\n'
     'extern "C" const char* mk_error_string(int err) {'),
]

#: the weight ring's kernel (ring_pass: thread 0 computes, warp 15 issues)
#: in place of the register pass's two edits
RING_EDITS = [
    ("    mb_wait(rh->full + s, (seq / NS) & 1u, heap, S, seq);\n",
     "    mb_wait(rh->full + s, (seq / NS) & 1u, heap, S, seq);\n"
     "    if (threadIdx.x == 0 && r0 == 0 && g0 == 0 && k0 == 0 && !ep.mul)\n"
     "      stamp_raw(3);\n"),
    ("  if (nks > 1) {                        // then CPT == 1: reduce K "
     "slices\n",
     "  if (threadIdx.x == 0 && r0 == 0 && !ep.mul) stamp_raw(4);\n"
     "  if (nks > 1) {                        // then CPT == 1: reduce K "
     "slices\n"),
]

RING_FNS = '''// The stamp of a function that has no Smem: the slot at its fixed place.
__device__ __forceinline__ void stamp_raw(int k) {
  const long long slot = *reinterpret_cast<const long long*>(
      reinterpret_cast<const float*>(smem_raw + (RING + 1) * ROW_BYTES) + 20);
  if (g_stamp != nullptr && slot >= 0) g_stamp[slot * 8 + k] = stamp_ns();
}

'''


def _edit(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"prefetch_variants: {text.count(old)} matches "
                         f"of {old[:60]!r}")
    return text.replace(old, new)


def stamped(text: str) -> str:
    """``text`` (a megakernel.cu) with the per-task stamps."""
    edits = STAMP_EDITS
    if "ring_pass" in text:              # the weight ring's kernel
        edits = ([(edits[0][0], STAMP_FNS + RING_FNS + edits[0][0])]
                 + RING_EDITS + edits[3:])
    for old, new in edits:
        text = _edit(text, old, new)
    return text


def _write(out: Path, src_root: Path, text: str) -> None:
    pkg = out / "src" / "repro_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(src_root / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (out / "src" / CU).write_text(text)
    print(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path, help="directory for the copies")
    ap.add_argument("--stamp", type=Path, nargs="+", required=True,
                    help="roots whose stamped copies to write")
    args = ap.parse_args()
    for root in args.stamp:
        root = root.resolve()
        name = "stamp-" + ("change" if root == ROOT else root.name)
        _write(args.out / name, root, stamped((root / "src" / CU).read_text()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
