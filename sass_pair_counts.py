#!/usr/bin/env python3
"""Per-pair instructions of the star loops of kernels 1, 3, 6, 8, 12 and
13, and the inner loops of kernels 9, 10, 11 and 15, read from SASS.

Run from the root of the repository, on a machine with the CUDA toolkit:

    python3 sass_pair_counts.py

It builds the port's kernels (``mcmc_dynamics_tpu_torch.ops._build``), runs
``cuobjdump -sass`` on the library and, for each instantiation of
``model_lnlike_kernel``, ``model_freecenter_kernel``, ``model_mixture_kernel``,
``double_model_gb_kernel``, ``constant_gb_v2_kernel`` and
``model_gb_v2_kernel``, finds the star loop: the smallest loop (a backward
branch) that issues MUFU operations.  Its pair count is its MUFU.EX2 count
in kernels 6, 8, 12 and 13 (one ``expf`` a pair) and half its
MUFU.RSQ count in kernels 1 and 3 (two ``rsqrtf`` a pair, no ``expf``), and
it prints, per pair, the instructions, the FP32 flops (FFMA x 2 + FMUL +
FADD) and the MUFU operations by function.  This is what the compiled code
issues, not what the function needs: ``chip_smoke.PAIR_COST`` counts the
latter, for the bounds.  For ``model_sufficient_kernel``,
``background_lse_kernel`` and ``model_sufficient_mma_kernel`` it prints every
innermost loop's instructions by op (kernel 9's loop over the Chebyshev
order, kernel 10's max and sum sweeps, kernel 11's loop over a group's bins:
its HGMMA, shuffles and the rest of a bin; kernel 15's loop over the staged
chunks of radial orders), and for each instantiation of kernel 11 its HGMMA,
SHFL and local-memory (LDL, STL) instructions in all, of kernel 15 its
FFMAs, shared loads, local memory and any tensor-core or atomic instruction
(HMMA, HGMMA, ATOM, RED: none is expected).
"""

from __future__ import annotations

import pathlib
import re
import subprocess
from collections import Counter

# kernel -> (the MUFU function that counts its pairs, its operations a pair)
KERNELS = {"model_lnlike_kernel": ("RSQ", 2), "model_freecenter_kernel": ("RSQ", 2),
           "model_mixture_kernel": ("EX2", 1), "double_model_gb_kernel": ("EX2", 1),
           "constant_gb_v2_kernel": ("EX2", 1), "model_gb_v2_kernel": ("EX2", 1)}
# kernels whose every innermost loop is listed by op
LOOP_KERNELS = ("model_sufficient_kernel", "background_lse_kernel",
                "model_sufficient_mma_kernel", "jam_grid_reconstruct_kernel")
# kernels whose whole function's count of these ops is listed
TOTAL_KERNELS = {"model_sufficient_mma_kernel": ("HGMMA", "SHFL", "LDL", "STL"),
                 "jam_grid_reconstruct_kernel": ("FFMA", "LDS", "LDGSTS", "LDL", "STL",
                                                 "HMMA", "HGMMA", "ATOM", "ATOMS",
                                                 "ATOMG", "RED")}


def _instructions(block):
    """(address, op, text) of each instruction of one function's SASS."""
    ins = []
    for addr, body in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block):
        body = re.sub(r"^@!?U?P\w+\s+", "", body.strip())
        op = body.split()[0] if body else ""
        # FFMA.SAT, FFMA.RM, ... are FFMAs; MUFU keeps its function
        ins.append((int(addr, 16), op if op.startswith("MUFU") else op.split(".")[0],
                    body))
    return ins


def _loops(ins):
    """(start, end, Counter of ops) of every loop: a backward branch."""
    loops = []
    for addr, op, body in ins:
        target = re.search(r"0x([0-9a-f]+)", body) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            start = int(target.group(1), 16)
            loops.append((start, addr, Counter(o for a, o, _ in ins if start <= a <= addr)))
    return loops


def loop_histograms(sass: str, kernels=LOOP_KERNELS) -> list[str]:
    """Every innermost loop of each of ``kernels``: its instructions by op
    (kernel 9's order loop, kernel 10's max and sum sweeps)."""
    lines = []
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        name = block.split("\n", 1)[0]
        kernel = next((k for k in kernels if k in name), None)
        if kernel is None:
            continue
        loops = _loops(_instructions(block))
        for start, end, ops in loops:
            if any(s > start and e < end for s, e, _ in loops):
                continue                             # not innermost
            top = ", ".join(f"{o} {n}" for o, n in ops.most_common())
            lines.append(f"{kernel}: loop 0x{start:x}-0x{end:x}, {sum(ops.values())} "
                         f"instructions: {top}")
    return lines


def function_totals(sass: str, kernels=TOTAL_KERNELS) -> list[str]:
    """For each instantiation of ``kernels``, its count of each listed op in
    the whole function (kernel 11: HGMMA, shuffles, local memory)."""
    lines = []
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        name = block.split("\n", 1)[0]
        kernel = next((k for k in kernels if k in name), None)
        if kernel is None:
            continue
        ops = Counter(o for _, o, _ in _instructions(block))
        template = re.search(r"ILi(\d+)E", name)
        tag = f"{kernel}<{template.group(1)}>" if template else kernel
        lines.append(f"{tag}: {sum(ops.values())} instructions, "
                     + ", ".join(f"{o} {ops[o]}" for o in kernels[kernel]))
    return lines


def star_loop_counts(sass: str) -> list[str]:
    """One line per kernel instantiation found in the text of ``cuobjdump
    -sass``."""
    lines = []
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        name = block.split("\n", 1)[0]
        kernel = next((k for k in KERNELS if k in name), None)
        if kernel is None:
            continue
        loops = [(end - start, ops) for start, end, ops in _loops(_instructions(block))
                 if any(o.startswith("MUFU") for o in ops)]
        if not loops:
            continue
        ops = min(loops, key=lambda x: x[0])[1]
        function, per_pair = KERNELS[kernel]
        pairs = ops[f"MUFU.{function}"] / per_pair
        if not pairs:
            continue
        mufu = {o[5:]: n / pairs for o, n in ops.items() if o.startswith("MUFU")}
        fp32 = {o: ops[o] / pairs for o in ("FFMA", "FMUL", "FADD")}
        flops = 2 * fp32["FFMA"] + fp32["FMUL"] + fp32["FADD"]
        template = re.search(r"ILi(\d+)E(Lb(\d)E)?", name)
        tag = f"{kernel}<{template.group(1)}" + (
            f", {'true' if template.group(3) == '1' else 'false'}>"
            if template.group(2) else ">")
        lines.append(f"{tag}: star loop of {pairs:g} pairs, per pair "
                     f"{sum(ops.values()) / pairs:.3g} instructions, {flops:g} FP32 "
                     f"flops (FFMA {fp32['FFMA']:g}, FMUL {fp32['FMUL']:g}, FADD "
                     f"{fp32['FADD']:g}) and {sum(mufu.values()):g} MUFU {mufu}")
    return lines


def main() -> int:
    from mcmc_dynamics_tpu_torch.ops._build import build_library, find_nvcc

    info = build_library()
    cuobjdump = pathlib.Path(find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(info.path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    lines = star_loop_counts(sass) + loop_histograms(sass) + function_totals(sass)
    for line in lines:
        print(line)
    return 0 if lines else 1


if __name__ == "__main__":
    raise SystemExit(main())
