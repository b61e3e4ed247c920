#!/usr/bin/env python3
"""Time variants of a kernel's source beside the source as it is.

Run from the root of the repository, on a machine with the CUDA toolkit and
one NVIDIA GPU:

    python3 kernel_variants.py                    # every kernel of VARIANTS
    python3 kernel_variants.py constant_mixture   # one of them
    python3 kernel_variants.py model_sufficient background_lse
    python3 kernel_variants.py constant_gb_v2 model_gb_v2

A variant is a kernel's ``csrc/`` source (or a header it includes) with
some of its text replaced (``VARIANTS`` below: the other way of a choice the
source makes).  Each is compiled by its own nvcc, with the build's flags,
into a library of its own; for its timings its launcher takes the place
of the built one in the kernel's ``Kernel``, so the wrapper, its checks and
its scratch are the source's.  For each kernel, shape and variant it prints the max_abs_err of
the source and of the variant against the float64 plain version (at the
kernel's gate: a variant that misses it says so) and their device times
(``chip_smoke.cuda_ms``), taken in turns: source, variant, variant,
source; then the SM clock and power that nvidia-smi reads while the source
runs back to back at the kernel's slowest shape, and each variant's ptxas
registers and spills.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

import chip_smoke

CSRC = pathlib.Path(__file__).resolve().parent / "mcmc_dynamics_tpu_torch" / "csrc"

# kernel -> (source, {variant: [(text in the source, its replacement), ...]})
_ACCURATE_LOG = ("(__logf(rs)", "(logf(rs)")
_SMEM_CONSTANTS = [
    ("  Walker m[TW];\n", "  const Walker* m;                 // the tile's, in shared memory\n"),
    ("""      : rows(r) {
#pragma unroll
    for (int k = 0; k < TW; ++k)
      // the ragged last tile repeats the last walker and never writes it
      m[k].set(params + 4 * min(w0 + k, n_walkers - 1));
  }""", """      : rows(r),
        m(walker_reduce::tile_constants<TW, Walker>(
            w0, n_walkers, [&](Walker& c, int w) { c.set(params + 4 * w); })) {}""")]
_LOG1P = "__logf(1.0f + __expf(-fabsf(a - s.lb)))"
# kernel 10: the max sweep, the rescale and the sum sweep of a chunk, against
# the earlier online update a pair (a running max and one partial sum)
_CHUNK_MAX = """  float d_min[T];
#pragma unroll
  for (int t = 0; t < T; ++t) d_min[t] = INFINITY;
#pragma unroll 4
  for (int i = lane; i < n4; i += kLanes) {
    const float4 c = c4[i];
#pragma unroll
    for (int t = 0; t < T; ++t)
      d_min[t] = fminf(d_min[t], fminf(fminf(fabsf(c.x - vt[t]), fabsf(c.y - vt[t])),
                                       fminf(fabsf(c.z - vt[t]), fabsf(c.w - vt[t]))));
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float m_c = k2[t] * (d_min[t] * d_min[t]);
    if (m_c > m[t]) {
      const float r = pow2(m[t] - m_c);           // 0 while m is -inf
#pragma unroll
      for (int q = 0; q < 4; ++q) s[t][q] *= r;
      m[t] = m_c;
    }
  }
#pragma unroll 4
  for (int i = lane; i < n4; i += kLanes) {
    const float4 c = c4[i];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float x0 = c.x - vt[t], x1 = c.y - vt[t], x2 = c.z - vt[t], x3 = c.w - vt[t];
      s[t][0] += pow2(fmaf(x0 * x0, k2[t], -m[t]));
      s[t][1] += pow2(fmaf(x1 * x1, k2[t], -m[t]));
      s[t][2] += pow2(fmaf(x2 * x2, k2[t], -m[t]));
      s[t][3] += pow2(fmaf(x3 * x3, k2[t], -m[t]));
    }
  }"""
_PAIR_MAX = """#pragma unroll 4
  for (int i = lane; i < n4; i += kLanes) {
    const float4 c = c4[i];
    const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = cs[q] - vt[t];
        const float e = k2[t] * (x * x);
        const float hi = fmaxf(m[t], e);
        const float ex = pow2(fminf(m[t], e) - hi);
        s[t][0] = e > m[t] ? fmaf(s[t][0], ex, 1.0f) : s[t][0] + ex;
        m[t] = hi;
      }
    }
  }"""
# kernels 12 and 13: the accurate functions in place of density_mixture::FastMath
_ACCURATE_MATH = ("using Math = density_mixture::FastMath;", """struct Math {
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float log1p_exp(float x) { return log1pf(expf(x)); }
};""")
# kernels 12 and 13: walker_reduce.cuh's split_reduce_groups, a chunk's sums
# (blockIdx.y's), and the loads of a group's G stars in one step
_CHUNK_SUMS = """  const int end = min(n_stars, (c + 1) * star_chunk);
  float acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) acc[k] = 0.0f;
  float live = 0.0f;
  for (int base = c * star_chunk; base < end; base += G * kThreads) {
    typename Body::Star s[G];
    bool on[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      s[j] = body.load(min(i, n_stars - 1));
      on[j] = i < end && body.live(s[j]);
      live += on[j] ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      typename Body::Group group;
#pragma unroll
      for (int j = 0; j < G; ++j) body.add(k, j, on[j], s[j], group);
      acc[k] += group.total();
    }
  }
#pragma unroll
  for (int k = 0; k < TW; ++k) acc[k] = fmaf(live, body.per_live(k), acc[k]);
  __shared__ float red[TW][kWarps];
  block_reduce_spread<TW>(acc, red);
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers)
    dst[static_cast<size_t>(c) * n_walkers + w0 + threadIdx.x] =
        block_total(red, threadIdx.x);
"""
_GROUP_STEP = _CHUNK_SUMS[_CHUNK_SUMS.index("    typename Body::Star s[G];"):
                          _CHUNK_SUMS.index("  }\n#pragma unroll\n  for (int k = 0; k < TW; ++k) acc[k] = fmaf")]


def _stars_a_step(n):
    """split_reduce_groups loading n of a group's G stars a step at the
    8-walker tile, each walker's group carried over the steps (the same
    terms in the same order)."""
    return ("walker_reduce.cuh", _GROUP_STEP, f"""    typename Body::Group group[TW];
    constexpr int S = TW == 8 ? {n} : G;
#pragma unroll
    for (int j0 = 0; j0 < G; j0 += S) {{
      typename Body::Star s[S];
      bool on[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {{
        const int i = base + (j0 + j) * kThreads + threadIdx.x;
        s[j] = body.load(min(i, n_stars - 1));
        on[j] = i < end && body.live(s[j]);
        live += on[j] ? 1.0f : 0.0f;
      }}
#pragma unroll
      for (int k = 0; k < TW; ++k) {{
#pragma unroll
        for (int j = 0; j < S; ++j) body.add(k, j0 + j, on[j], s[j], group[k]);
      }}
    }}
#pragma unroll
    for (int k = 0; k < TW; ++k) acc[k] += group[k].total();
""")


def _walk_chunks(kernel):
    """At the 8-walker tile a block takes up to 8 chunks one after another
    (the tile's constants set and the block started once, not once a chunk;
    the same bits), a grid of ceil(chunks / 8) blocks over blockIdx.y."""
    body = _CHUNK_SUMS.replace("  __shared__ float red[TW][kWarps];\n", "")
    return [("walker_reduce.cuh", "  const int c = blockIdx.y;\n" + _CHUNK_SUMS,
             """  __shared__ float red[TW][kWarps];
  constexpr int kWalk = TW == 8 ? 8 : 1;
  const int n_chunks = (n_stars + star_chunk - 1) / star_chunk;
  for (int c = blockIdx.y * kWalk; c < min(n_chunks, (blockIdx.y + 1) * kWalk); ++c) {
""" + "".join("  " + ln if ln.strip() else ln for ln in body.splitlines(True))
             + "    __syncthreads();   // red is read before the next chunk's sums\n  }\n"),
            (f"        {kernel}<TW><<<grid,",
             f"        grid.y = TW == 8 ? (grid.y + 7) / 8 : grid.y;\n"
             f"        {kernel}<TW><<<grid,")]


_MIN_BLOCKS = "kMinBlocks = TW == 8 ? 3 : 4;"
_TWO_BLOCKS = (_MIN_BLOCKS, "kMinBlocks = TW == 8 ? 2 : 4;")
_FOUR_BLOCKS = (_MIN_BLOCKS, "kMinBlocks = TW == 8 ? 4 : 4;")
_TWO_BLOCKS_AT_TWO = (_MIN_BLOCKS, "kMinBlocks = TW == 8 ? 3 : 2;")
_FOUR_WALKERS = [("          ? launch<8>(", "          ? launch<4>("),
                 (_MIN_BLOCKS, "kMinBlocks = TW == 2 ? 4 : 3;")]


def _constants_in_registers(n_params):
    """Kernels 12 and 13 with each thread holding its tile's Walker
    constants in registers, set by every thread, at two blocks an SM (128
    registers) at the 8-walker tile."""
    return [("  const Walker* m;                  // the tile's, in shared memory\n",
             "  Walker m[TW];\n"),
            (f"""      : rows(r),
        m(walker_reduce::tile_constants<TW, Walker>(
            w0, n_walkers, [&](Walker& c, int w) {{ c.set(params + {n_params} * w); }})) {{}}""",
             f"""      : rows(r) {{
#pragma unroll
    for (int k = 0; k < TW; ++k) m[k].set(params + {n_params} * min(w0 + k, n_walkers - 1));
  }}"""),
            _TWO_BLOCKS]


_GB_V2_RCP = """    const float inv = density_mixture::rcp_approx(norm * nb);
    const float inv_norm = nb * inv;
    const float inv_nb = norm * inv;
"""
_MODEL_V2_RCP = """    const float qn = q * q * norm;
    const float inv = density_mixture::rcp_approx(qn * nb);
    const float dr2 = d2 * d2 * (nb * inv);
    const float qnb = q * nb;
    const float db = s.v - w.v_back;
    const float db2 = on ? db * db * (qn * inv) : 0.0f;
    const float delta = (s.ln_d - w.ln_f) + 0.5f * Math::log(qnb * qnb * inv)
"""
VARIANTS = {
    "constant_gb_v2": ("constant_gb_v2.cu", {
        "logf, log1pf(expf) (the accurate functions)": [_ACCURATE_MATH],
        "IEEE divisions 1 / n, 1 / nb": [(_GB_V2_RCP, """    const float inv_norm = 1.0f / norm;
    const float inv_nb = 1.0f / nb;
""")],
        "two rsqrtf (1 / n = rs^2, 1 / nb = rb^2)": [(_GB_V2_RCP, """    const float rs = rsqrtf(norm), rb = rsqrtf(nb);
    const float inv_norm = rs * rs;
    const float inv_nb = rb * rb;
""")],
        "__fdividef for the shared reciprocal": [
            ("density_mixture::rcp_approx(norm * nb)", "__fdividef(1.0f, norm * nb)")],
        "1 star a step at the 8-walker tile": [_stars_a_step(1)],
        "2 stars a step at the 8-walker tile": [_stars_a_step(2)],
        "up to 8 chunks a block at the 8-walker tile": _walk_chunks("constant_gb_v2_kernel"),
        "the tile's constants in registers (two blocks an SM)":
            _constants_in_registers(7),
        "two blocks an SM at the 8-walker tile": [_TWO_BLOCKS],
        "four blocks an SM at the 8-walker tile": [_FOUR_BLOCKS],
        "two blocks an SM at the 2-walker tile": [_TWO_BLOCKS_AT_TWO],
        "4-walker wide tile (three blocks an SM)": _FOUR_WALKERS,
    }),
    "model_gb_v2": ("model_gb_v2.cu", {
        "logf, log1pf(expf) (the accurate functions)": [_ACCURATE_MATH],
        "IEEE divisions (d^2 / (q^2 n), 1 / nb, nb / n)": [(_MODEL_V2_RCP, """    const float dr2 = (d2 * d2) / (q * q * norm);
    const float db = s.v - w.v_back;
    const float db2 = on ? db * db * (1.0f / nb) : 0.0f;
    const float delta = (s.ln_d - w.ln_f) + 0.5f * Math::log(nb / norm)
""")],
        "two rsqrtf (of q^2 n and of nb)": [(_MODEL_V2_RCP, """    const float rq = rsqrtf(q * q * norm), rb = rsqrtf(nb);
    const float t = d2 * rq;
    const float dr2 = t * t;
    const float qr = q * rq;
    const float db = s.v - w.v_back;
    const float db2 = on ? db * db * (rb * rb) : 0.0f;
    const float delta = (s.ln_d - w.ln_f) + 0.5f * Math::log(nb * (qr * qr))
""")],
        "__fdividef for the shared reciprocal": [
            ("density_mixture::rcp_approx(qn * nb)", "__fdividef(1.0f, qn * nb)")],
        "1 star a step at the 8-walker tile": [_stars_a_step(1)],
        "2 stars a step at the 8-walker tile": [_stars_a_step(2)],
        "up to 8 chunks a block at the 8-walker tile": _walk_chunks("model_gb_v2_kernel"),
        "the tile's constants in registers (two blocks an SM)":
            _constants_in_registers(9),
        "two blocks an SM at the 8-walker tile": [_TWO_BLOCKS],
        "four blocks an SM at the 8-walker tile": [_FOUR_BLOCKS],
        "two blocks an SM at the 2-walker tile": [_TWO_BLOCKS_AT_TWO],
        "4-walker wide tile (three blocks an SM)": _FOUR_WALKERS,
    }),
    "constant_mixture": ("constant_mixture.cu", {
        "logf, log1pf(expf) (the accurate pair)": [
            _ACCURATE_LOG, (_LOG1P, "log1pf(expf(-fabsf(a - s.lb)))")],
        "logf(rs)": [_ACCURATE_LOG],
        "log1pf(__expf)": [(_LOG1P, "log1pf(__expf(-fabsf(a - s.lb)))")],
        "tile_constants": _SMEM_CONSTANTS,
    }),
    "model_tensor": ("model_tensor.cu", {
        "4-walker small tile": [("kSmallTile = 8;", "kSmallTile = 4;")],
        "32-walker wide tile": [("kWideTile = 16;", "kWideTile = 32;")],
        "small tile's a-rank loop unrolled by 4": [
            ("TW == kWideTile ? 4 : 12;", "TW == kWideTile ? 4 : 4;")],
        "wide tile's a-rank loop unrolled by 8": [
            ("TW == kWideTile ? 4 : 12;", "TW == kWideTile ? 8 : 12;")],
        "wide tile's a-rank loop unrolled by 12": [
            ("TW == kWideTile ? 4 : 12;", "TW == kWideTile ? 12 : 12;")],
        "bases read from L2": [
            ("cheb_dot(s_xi[TW + idx % TW], s_ua + idx / TW, t.d_a, t.ra)",
             "cheb_dot(s_xi[TW + idx % TW], t.u_a + idx / TW, t.d_a, t.ra)"),
            ("cheb_dot(s_xi[idx % TW], s_us + idx / TW, t.d_s, n_ps)",
             "cheb_dot(s_xi[idx % TW], t.u_s + i_first + idx / TW, t.d_s, t.rs)")],
        "a block barrier after each pass": [
            ("      warp_reduce_spread<TW>(acc,",
             "      walker_reduce::block_reduce_spread<TW>(acc,")],
        "wide tile one chunk a block": [
            ("const int per_block = TW == kWideTile ? min(n_chunks, kMaxPerBlock) : 1;",
             "const int per_block = 1;")],
    }),
    "model_sufficient": ("model_sufficient.cu", {
        "staging by plain loads": [
            ("""  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(src));""",
             "  *dst = *src;")],
        "one walker a lane": [
            ("constexpr int kWalkersPerLane = 2;", "constexpr int kWalkersPerLane = 1;")],
        "table read through L1, not staged": [
            ("""    float4* slab4 = smem4 + warp * n4;
    for (int i = lane; i < n4; i += 32) stage16(slab4 + i, row4 + i);""",
             "    const float4* slab4 = row4;")],
        "order loop unrolled by 2": [
            ("    for (int k = 1; k < n_coef; ++k) {",
             "#pragma unroll 2\n    for (int k = 1; k < n_coef; ++k) {")],
        "three walkers a lane": [
            ("constexpr int kWalkersPerLane = 2;", "constexpr int kWalkersPerLane = 3;")],
        "staging in two halves, the second waited for at half the orders": [
            ("    for (int i = lane; i < n4; i += 32) stage16(slab4 + i, row4 + i);\n",
             """    const int k_half = n_coef / 2, n4a = k_half * (kChannelsPad / 4);
    for (int i = lane; i < n4a; i += 32) stage16(slab4 + i, row4 + i);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
    for (int i = n4a + lane; i < n4; i += 32) stage16(slab4 + i, row4 + i);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
"""),
            ("    cp_async_wait();\n    __syncwarp();\n",
             '    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");\n    __syncwarp();\n'),
            ("    for (int k = 1; k < n_coef; ++k) {\n      if (k > 1) {",
             """    for (int k = 1; k < n_coef; ++k) {
      if (k == k_half) {
        asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
        __syncwarp();
      }
      if (k > 1) {""")],
        "no finishing pass (a timing probe: wrong values)": [
            ("  return static_cast<int>(finish(partial, n_groups, n_walkers, n_stars, out, s));",
             "  return 0;")],
    }),
    "background_lse": ("background_lse.cu", {
        "expf": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                  "y = expf(x * kLn2);")],
        "the max a pair (one running max and sum)": [(_CHUNK_MAX, _PAIR_MAX)],
        "one target a thread": [("constexpr int T = 2;", "constexpr int T = 1;")],
        "4 lanes a target": [("constexpr int kLanes = 16;", "constexpr int kLanes = 4;")],
        "8 lanes a target": [("constexpr int kLanes = 16;", "constexpr int kLanes = 8;")],
        "32 lanes a target": [("constexpr int kLanes = 16;", "constexpr int kLanes = 32;")],
        "four targets a thread": [("constexpr int T = 2;", "constexpr int T = 4;")],
        "sum sweep unrolled by 2": [
            ("#pragma unroll 4\n  for (int i = lane; i < n4; i += kLanes) {\n    const float4 c = c4[i];\n"
             "#pragma unroll\n    for (int t = 0; t < T; ++t) {\n      const float x0",
             "#pragma unroll 2\n  for (int i = lane; i < n4; i += kLanes) {\n    const float4 c = c4[i];\n"
             "#pragma unroll\n    for (int t = 0; t < T; ++t) {\n      const float x0")],
        "chunks of 4096 stars": [("kChunk = 2048;", "kChunk = 4096;")],
        "chunks of 1024 stars": [("kChunk = 2048;", "kChunk = 1024;")],
        "no max sweep (a timing probe: the shift from a lane's first star)": [
            ("""#pragma unroll 4
  for (int i = lane; i < n4; i += kLanes) {
    const float4 c = c4[i];
#pragma unroll
    for (int t = 0; t < T; ++t)
      d_min[t] = fminf(d_min[t], fminf(fminf(fabsf(c.x - vt[t]), fabsf(c.y - vt[t])),
                                       fminf(fabsf(c.z - vt[t]), fabsf(c.w - vt[t]))));
  }""", """#pragma unroll
  for (int t = 0; t < T; ++t) d_min[t] = fabsf(c4[lane].x - vt[t]);""")],
        "no exp (a timing probe: wrong values)": [
            ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")],
    }),
}


def build_variants(kernel_name):
    """{variant: (ctypes library, ptxas lines)}, one nvcc per variant, all
    started together."""
    from mcmc_dynamics_tpu_torch.ops._build import _NVCC_FLAGS, find_nvcc

    source, variants = VARIANTS[kernel_name]
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="kernel_variants_"))
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = tmp / f"v{i}" / source
        shutil.copytree(CSRC, src.parent)
        for edit in edits:
            # (old, new) in the kernel's source, (file, old, new) in a header
            target, old, new = edit if len(edit) == 3 else (source, *edit)
            path = src.parent / target
            var = path.read_text()
            if old not in var:
                raise ValueError(f"{kernel_name} variant {name!r}: {old!r} not in {target}")
            path.write_text(var.replace(old, new))
        lib = src.with_suffix(".so")
        cmd = [find_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{out}")
        ptxas = [ln.strip() for ln in out.splitlines() if "Used" in ln or "spill" in ln]
        built[name] = (ctypes.CDLL(str(lib)), ptxas)
    return built, tmp


def kernel_cases(kernel_name, device):
    """(Kernel, [(label, run, args, plain on float64 args, tol)]) at the
    kernel's shapes: its main path's and 16384 walkers (kernel 10: 20480
    targets over path E2's 8192 catalog stars and a ragged 3001; kernels 12
    and 13, on no path, at 128 x 20480 and 16384 x 10240)."""
    import torch

    from mcmc_dynamics_tpu_torch import ops

    if kernel_name == "constant_mixture":
        make = chip_smoke.constant_inputs(device, gb=False)
        cases = []
        for shape in ((128, 20_480, 0), (16384, 10_000, 240)):
            a32 = make(shape)[0]

            def plain(a32=a32):
                a64 = [t.double() for t in a32]
                return torch.cat([ops.constant_mixture_lnlike_reference(p, *a64[1:])
                                  for p in torch.split(a64[0], 2048)])
            cases.append((chip_smoke.size_label(shape), chip_smoke.constant_mixture_split,
                          a32, plain, chip_smoke.DIRECT_TOL))
        return ops.CONSTANT_MIXTURE, cases
    if kernel_name in ("constant_gb_v2", "model_gb_v2"):
        v2 = kernel_name == "constant_gb_v2"
        make = (chip_smoke.constant_inputs(device, gb=True) if v2
                else chip_smoke.model_gb_v2_inputs(device))
        run = ops.constant_gb_v2_lnlike_batched if v2 else ops.model_gb_v2_lnlike_batched
        ref = (ops.constant_gb_v2_lnlike_reference if v2
               else ops.model_gb_v2_lnlike_reference)
        cases = []
        for shape in ((128, 20_480, 0), (16384, 10_000, 240)):
            a32, _, kw64, _ = make(shape)

            def plain(a32=a32, kw64=kw64):
                a64 = [t.double() for t in a32]
                return torch.cat([ref(p, *a64[1:], **kw64)
                                  for p in torch.split(a64[0], 2048)])
            cases.append((chip_smoke.size_label(shape), run, a32, plain,
                          chip_smoke.DIRECT_TOL))
        return ops.KERNELS[kernel_name], cases
    if kernel_name == "model_sufficient":
        fit, _ = chip_smoke.mock_fit(device, n_stars=100_000, seed=5, bounded=False)
        stats = fit.sufficient_stats()
        stats64 = stats.to(dtype=torch.float64)
        cases = []
        for n_walkers in (512, 16384):
            params = chip_smoke.near_truth_params(n_walkers, seed=n_walkers, device=device)

            def plain(params=params):
                return torch.cat([stats64.lnlike(p)
                                  for p in torch.split(params.double(), 1024)])
            cases.append((f"{n_walkers} walkers",
                          lambda p: ops.model_sufficient_lnlike(stats, p), [params],
                          plain, chip_smoke.TENSOR_TOL))
        return ops.MODEL_SUFFICIENT, cases
    if kernel_name == "background_lse":
        make = chip_smoke.background_inputs(device)
        cases = []
        for shape in ((20_480, 8192, 0), (20_480, 3001, 0)):
            a32 = make(shape)[0]

            def plain(a32=a32):
                return ops.background_logsumexp_reference(*[t.double() for t in a32])
            cases.append((chip_smoke.size_label(shape), ops.background_logsumexp, a32,
                          plain, chip_smoke.BACKGROUND_TOL))
        return ops.BACKGROUND_LSE, cases
    fit, _ = chip_smoke.mock_fit(device, n_stars=100_000, seed=5)
    stats = fit.tensor_stats()
    stats64 = stats.to(dtype=torch.float64)
    cases = []
    for n_walkers in (512, 16384):
        params = chip_smoke.tensor_inputs(stats, device)((n_walkers,))[0][0]

        def plain(params=params):
            return torch.cat([stats64.lnlike(p) for p in torch.split(params.double(), 4096)])
        cases.append((f"{n_walkers} walkers", lambda p: ops.model_tensor_lnlike(stats, p),
                      [params], plain, chip_smoke.TENSOR_TOL))
    return ops.MODEL_TENSOR, cases


def clocks_under_load(run, args, seconds=2.0):
    """(median SM clock MHz, its maximum MHz, median power W) that nvidia-smi
    reads every 100 ms while ``run(*args)`` is launched back to back for
    ``seconds``: the clock the kernel's times were taken at, to hold them
    against bounds computed at the card's 1.98 GHz boost."""
    import time

    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(100):
                run(*args)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = [[float(x) for x in ln.split(",")] for ln in out.splitlines() if ln.strip()]
    # the first samples may predate the load
    rows = rows[len(rows) // 4:] or rows
    return tuple(statistics.median(r[i] for r in rows) for i in range(3))


def error(label, got, ref, tol) -> str:
    try:
        return f"{chip_smoke.compare(label, got, ref, **tol):.4g}"
    except AssertionError as exc:
        return f"FAILS the gate ({str(exc).splitlines()[0]})"


def main(argv=None) -> int:
    import torch

    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"kernel_variants on {smi}")
    for kernel_name in names:
        built, tmp = build_variants(kernel_name)
        kernel, cases = kernel_cases(kernel_name, device)
        own = kernel._fn                     # the built library's launcher
        slowest = None
        try:
            for label, run, args, plain, tol in cases:
                ref = plain()
                base_err = error(f"{kernel_name} {label}", run(*args), ref, tol)
                for name, (lib, _) in built.items():
                    fn = getattr(lib, kernel.symbol)
                    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
                    kernel.__dict__["_fn"] = fn
                    var_err = error(f"{kernel_name} {label} {name}", run(*args), ref, tol)
                    times = []
                    for f in (own, fn, fn, own):
                        kernel.__dict__["_fn"] = f
                        times.append(chip_smoke.cuda_ms(lambda: run(*args)))
                    kernel.__dict__["_fn"] = own
                    print(f"{kernel_name} {label}: source {times[0]:.4f}, {times[3]:.4f} "
                          f"ms, max_abs_err {base_err} | variant {name!r} {times[1]:.4f}, "
                          f"{times[2]:.4f} ms, max_abs_err {var_err} | variant/source "
                          f"{(times[1] + times[2]) / (times[0] + times[3]):.3f}")
                    if slowest is None or times[0] > slowest[0]:
                        slowest = (times[0], label, run, args)
            mhz, max_mhz, watts = clocks_under_load(*slowest[2:])
            print(f"{kernel_name} {slowest[1]} launched back to back: SM clock {mhz:.0f} "
                  f"MHz (maximum {max_mhz:.0f}), power {watts:.1f} W (nvidia-smi, median "
                  "of 100 ms samples)")
        finally:
            kernel.__dict__["_fn"] = own
            shutil.rmtree(tmp, ignore_errors=True)
        for name, (_, ptxas) in built.items():
            print(f"  {kernel_name} variant {name!r} ptxas: " + " | ".join(ptxas))
    return 0


if __name__ == "__main__":
    sys.exit(main())
