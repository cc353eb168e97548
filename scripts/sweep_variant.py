#!/usr/bin/env python3
"""Write a copy of the port with one design choice of K1 and K8
(`csrc/sweep.cu` and its plan, `ops/bcd_sweep.py`) or of K9
(`csrc/sweep_tiled.cu` and its plan, `ops/bcd_sweep_tiled.py`) swapped for
another, so that `scripts/time_sweep.py --root DEST` and
`scripts/sharded_counts.py --root DEST` measure it beside the shipped
kernel in one chip call.

    python3 scripts/sweep_variant.py NAME DEST

Variants (NAME):
  grid_sync        the grid barriers as cooperative groups' grid.sync() in
                   place of the integer arrival counter (`counter_barrier`)
  pairwise_reduce  the split reduce's sums (16 partials per load batch,
                   then the warps' sums) as pairwise trees in place of
                   running sums
  no_prefetch      no b-row of tile j + 1 in flight across block j's
                   barriers (P = 0: the whole tile loads after phase 2)
  copies_4_byte    4-byte cp.async for the tile in place of 16-byte
  phases_unsplit   phases 1 and 2 in one segment each (S1 = S2 = 1)
  reduce_one_warp  one warp sums each reduced coordinate's G partials
  rows_16, rows_32, rows_64
                   at least that many rows per CTA (fewer CTAs at small m)
  payload_warp0    K8's running sums kept by warp 0 of CTA 0, which holds
                   phase-2 units, in place of its last warp, which holds
                   none at the rank slab
  k9_forward       K9's phase 2 in phase 1's order with nothing kept (every
                   chunk copied twice, as the first design did)
  k9_cp_async16    K9's float4 chunks by 16-byte cp.async from the producer
                   warp (each lane's first copy and stride worked out once
                   a chunk) in place of one bulk copy (1-D TMA) a run
  k9_l2_hints      K9's phase-1 bulk copies with an L2 evict_last policy
                   and phase 2's with evict_first
  k9_chunk_32k     K9's chunks of about 32 KB in place of 64

DEST (e.g. build/variant_grid_sync) receives this checkout's
`convex_optimization_tpu_torch/` with the variant's text replacements;
each replaced text must occur exactly once in its file.  The copy builds
its own kernel library under DEST/build/ at first use.
"""

from __future__ import annotations

import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "convex_optimization_tpu_torch"
CU = "csrc/sweep.cu"
PLAN = "ops/bcd_sweep.py"
TCU = "csrc/sweep_tiled.cu"
TPLAN = "ops/bcd_sweep_tiled.py"

#: name -> [(file in the package, text, its replacement)]
VARIANTS = {
    "grid_sync": [
        (CU, '#include "pipeline.cuh"\n',
         '#include <cooperative_groups.h>\n\n#include "pipeline.cuh"\n'),
        (CU, "    arrivals += gridDim.x;\n    counter_barrier(bar, arrivals);\n",
         "    (void)bar;\n    cooperative_groups::this_grid().sync();\n"),
    ],
    "pairwise_reduce": [
        (CU, "          for (int u = 0; u < 16; ++u) g += v[u];\n",
         "          for (int h = 8; h >= 1; h >>= 1) {\n"
         "#pragma unroll\n"
         "            for (int u = 0; u < h; ++u) v[u] += v[u + h];\n"
         "          }\n"
         "          g += v[0];\n"),
        (CU, "          g = 0.0f;\n"
         "          for (int w2 = 0; w2 < RW; ++w2) g += gs_s[w2 * 32 + lane];\n",
         "          float u16[16];\n"
         "#pragma unroll\n"
         "          for (int w2 = 0; w2 < 16; ++w2) {\n"
         "            u16[w2] = w2 < RW ? gs_s[w2 * 32 + lane] : 0.0f;\n"
         "          }\n"
         "#pragma unroll\n"
         "          for (int h = 8; h >= 1; h >>= 1) {\n"
         "#pragma unroll\n"
         "            for (int u = 0; u < h; ++u) u16[u] += u16[u + h];\n"
         "          }\n"
         "          g = u16[0];\n"),
    ],
    "no_prefetch": [
        (PLAN, "plan, prefetch=min(B, spare // (4 * ld)))",
         "plan, prefetch=0)"),
    ],
    "copies_4_byte": [
        (PLAN, "copy = 1 if plan.vec and _aligned(A_t) else 0", "copy = 0"),
    ],
    "phases_unsplit": [
        (PLAN, "cands += [(vec, rows, ld, s1, s2, K1_THREADS // 32),",
         "cands += [(vec, rows, ld, 1, 1, K1_THREADS // 32),"),
    ],
    "reduce_one_warp": [
        (PLAN, "cands += [(vec, rows, ld, s1, s2, K1_THREADS // 32),",
         "cands += [(vec, rows, ld, s1, s2, 1),"),
    ],
    **{f"rows_{k}": [(PLAN, "G0 = min(sms, m)", f"G0 = min(sms, -(-m // {k}))")]
       for k in (16, 32, 64)},
    "payload_warp0": [
        (CU, "constexpr int kPayWarp = kWarps - 1;",
         "constexpr int kPayWarp = 0;"),
    ],
    "k9_forward": [
        (TPLAN, "min(n_chunks, slots - 1)", "0"),
        (TCU, "const int k = l < N ? l : 2 * N - K - 1 - l;",
         "const int k = l < N ? l : l - N;"),
        (TCU, "const int k = N - 1 - p;", "const int k = p;"),
    ],
    "k9_cp_async16": [
        (TCU, "      mbar_init(full + s, 1);\n",
         "      mbar_init(full + s, VEC ? 32 : 1);\n"),
        (TCU, "    return;\n  }\n",
         "    asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
         "    return;\n  }\n"),
        (TCU, '      unsigned bytes = 0;\n      for (int b = lane; b < nb; b += 32) {\n        bytes += 4u * ((off(jj, b0 + b) + cnt + 3) & ~3);\n      }\n      bytes = __reduce_add_sync(0xffffffffu, bytes);\n      if (lane == 0) mbar_expect(full + slot, bytes);\n      __syncwarp();\n      for (int b = lane; b < nb; b += 32) {\n        const int d = off(jj, b0 + b);\n        bulk_copy(dst + b * ld, src + (size_t)b * m - d,\n                  4u * ((d + cnt + 3) & ~3), full + slot);\n      }\n',
         '      if constexpr (VEC) {  // 16-byte cp.async, no division a copy\n        const int per = cnt / 4;\n        int pb = lane / per, pi = lane - pb * per;\n        const int db = 32 / per, di = 32 - db * per;\n        while (pb < nb) {\n          cp_async<4>(dst + pb * ld + 4 * pi, src + (size_t)pb * m + 4 * pi);\n          pi += di;\n          pb += db;\n          if (pi >= per) {\n            pi -= per;\n            ++pb;\n          }\n        }\n        asm volatile(\n            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(\n                smem_u32(full + slot))\n            : "memory");\n        continue;\n      }\n      unsigned bytes = 0;\n      for (int b = lane; b < nb; b += 32) {\n        bytes += 4u * ((off(jj, b0 + b) + cnt + 3) & ~3);\n      }\n      bytes = __reduce_add_sync(0xffffffffu, bytes);\n      if (lane == 0) mbar_expect(full + slot, bytes);\n      __syncwarp();\n      for (int b = lane; b < nb; b += 32) {\n        const int d = off(jj, b0 + b);\n        bulk_copy(dst + b * ld, src + (size_t)b * m - d,\n                  4u * ((d + cnt + 3) & ~3), full + slot);\n      }\n'),
    ],
    "k9_l2_hints": [
        (TCU, "    const int total = n_blocks * LB;  // < 2^31 (the launch checks)\n",
         "    unsigned long long pol_last, pol_first;\n"
         "    asm volatile(\"createpolicy.fractional.L2::evict_last.b64 %0, "
         "1.0;\\n\" : \"=l\"(pol_last));\n"
         "    asm volatile(\"createpolicy.fractional.L2::evict_first.b64 %0, "
         "1.0;\\n\" : \"=l\"(pol_first));\n"
         "    const int total = n_blocks * LB;  // < 2^31 (the launch checks)\n"),
        (TCU, "        bulk_copy(dst + b * ld, src + (size_t)b * m - d,\n"
         "                  4u * ((d + cnt + 3) & ~3), full + slot);\n",
         "        asm volatile(\n"
         "            \"cp.async.bulk.shared::cluster.global.mbarrier::\"\n"
         "            \"complete_tx::bytes.L2::cache_hint [%0], [%1], %2, \"\n"
         "            \"[%3], %4;\\n\" ::\"r\"(smem_u32(dst + b * ld)),\n"
         "            \"l\"(src + (size_t)b * m - d),\n"
         "            \"r\"(4u * ((d + cnt + 3) & ~3)),\n"
         "            \"r\"(smem_u32(full + slot)),\n"
         "            \"l\"(l < N ? pol_last : pol_first) : \"memory\");\n"),
    ],
    "k9_chunk_32k": [
        (TPLAN, "K9_CHUNK_BYTES = 64 * 1024", "K9_CHUNK_BYTES = 32 * 1024"),
    ],
}


def main() -> None:
    if len(sys.argv) != 3 or sys.argv[1] not in VARIANTS:
        raise SystemExit(f"usage: sweep_variant.py {{{','.join(VARIANTS)}}} "
                         "DEST")
    name, dest = sys.argv[1], os.path.abspath(sys.argv[2])
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(os.path.join(HERE, PKG), os.path.join(dest, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = os.path.join(dest, PKG, rel)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            shutil.rmtree(dest)
            raise SystemExit(f"{name}: {old!r} occurs {src.count(old)} "
                             f"times in {rel}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    print(f"{name} -> {dest}")


if __name__ == "__main__":
    main()
