"""Q as a register operand against Q in shared memory in B2 / B3, on one
CUDA GPU.

    python3 chip_qpath.py

``csrc/prefill_sm90.cu`` takes S = Q K^T with Q from shared memory at
every head dim. This script builds a variant of it whose consumers hold Q
in registers (``qa[Dh / 16][4]``, the register A operand of
``wgmma_64x64``) at Dh 64 and 128, as the kernel did at 128 before, and:

- counts, in the variant's SASS (``cuobjdump -sass``), the instructions
  inside the chunk loop that write the registers the S products read as
  Q: a count above 0 means ptxas gave a loop-invariant operand's
  registers to other values, and every chunk after the first multiplies
  whatever they hold;
- holds the repository's build and the variant against the plain version
  on ``chip_smoke.py`` phase 2's B2 / B3 cases at Dh 64 and 128 (per-row
  bf16 ulps; whether the two builds' outputs are equal bit for bit);
- times both at Dh 128 in the order repo, variant, variant, repo
  (``chip_smoke.time_ms``, the means of each pair).

Prints one JSON line per case, then the card's name and power limit. It
exits non-zero if the repository's build disagrees with the plain version
or a build fails; the variant's faults are findings, not failures.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "qpath"

# (text of csrc/prefill_sm90.cu, the register-Q variant's text)
REGISTER_Q = [
    ("  static constexpr int Q_BYTES = ROWS * DH * 2;",
     "  static constexpr bool Q_SMEM = DH == 256;\n"
     "  static constexpr int Q_BYTES = Q_SMEM ? ROWS * DH * 2 : 0;"),
    ("    unsigned char* qs = gbase + wg * (NB * QBLOCK_BYTES);\n"
     "    for (int idx = tid % 128;",
     "    constexpr int QREGS = Gm::Q_SMEM ? 1 : DH / 16;\n"
     "    uint32_t qa[QREGS][4];\n"
     "    if constexpr (!Gm::Q_SMEM) {\n"
     "#pragma unroll\n"
     "      for (int kk = 0; kk < QREGS; ++kk)\n"
     "#pragma unroll\n"
     "        for (int hi = 0; hi < 2; ++hi)\n"
     "#pragma unroll\n"
     "          for (int k = 0; k < 2; ++k) {\n"
     "            float2 f = make_float2(0.f, 0.f);\n"
     "            if (has_slot[k])\n"
     "              f = __bfloat1622float2(*reinterpret_cast<const "
     "__nv_bfloat162*>(\n"
     "                  q + orow[k] + 16 * kk + 8 * hi + 2 * c4));\n"
     "            qa[kk][k + 2 * hi] = pack_bf16(f.x * sm_scale, "
     "f.y * sm_scale);\n"
     "          }\n"
     "    }\n"
     "    unsigned char* qs = gbase + wg * (NB * QBLOCK_BYTES);\n"
     "    if constexpr (Gm::Q_SMEM)\n"
     "    for (int idx = tid % 128;"),
    ("    fence_async_smem();\n    warpgroup_sync(BAR_Q + wg);\n",
     "    if constexpr (Gm::Q_SMEM) {\n      fence_async_smem();\n"
     "      warpgroup_sync(BAR_Q + wg);\n    }\n"),
    ("        wgmma_64x64_ss(s, smem_desc(qwg + (kk / 4) * QBLOCK_BYTES + "
     "(kk % 4) * 32),\n"
     "                       smem_desc(kst + (kk / 4) * HALF_BYTES + "
     "(kk % 4) * 32));",
     "        const uint64_t kd = smem_desc(kst + (kk / 4) * HALF_BYTES + "
     "(kk % 4) * 32);\n"
     "        if constexpr (Gm::Q_SMEM)\n"
     "          wgmma_64x64_ss(s, smem_desc(qwg + (kk / 4) * QBLOCK_BYTES + "
     "(kk % 4) * 32), kd);\n"
     "        else\n"
     "          wgmma_64x64<0>(s, qa[kk], kd);"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def variant_source(src: str) -> str:
    for now, then in REGISTER_Q:
        if src.count(now) != 1:
            raise RuntimeError(f"prefill_sm90.cu changed: {now[:60]!r}")
        src = src.replace(now, then)
    return src


def q_register_writes(sass: str) -> dict:
    """Per prefill_kernel instantiation whose S products read Q from
    registers: the Q registers and the writes to them between the chunk
    loop's head and its back edge."""
    found = {}
    for part in re.split(r"(?=Function : )", sass):
        m = re.match(r"Function : \S*prefill_kernelILi(\d+)ELb(\d)E", part)
        if not m:
            continue
        rows = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        s_mma = [(a, t) for a, t in rows
                 if t.startswith("HGMMA") and "tnspB" not in t]
        regs = set()
        for _a, t in s_mma:
            r = re.match(r"HGMMA\S*\s+R\d+,\s*R(\d+),", t)
            if r:
                regs.update(range(int(r.group(1)), int(r.group(1)) + 4))
        if not regs:
            continue            # Q from shared memory: nothing to count
        first, last_pv = min(a for a, _ in s_mma), max(
            a for a, t in rows if t.startswith("HGMMA") and "tnspB" in t)
        head = back = None
        for a, t in rows:
            b = re.search(r"BRA (?:\S+ )?0x([0-9a-f]+)$", t)
            if a > last_pv and b and int(b.group(1), 16) < first:
                head, back = int(b.group(1), 16), a
                break
        writes = 0
        for a, t in rows:
            if head is None or not head <= a <= back:
                continue
            t = re.sub(r"^@!?U?P\w+\s+", "", t)
            op, _, rest = t.partition(" ")
            d = re.match(r"R(\d+)", rest.strip())
            if d and not op.startswith(("HGMMA", "ST", "BAR", "SYNCS",
                                        "RED", "ATOM")):
                width = 2 if ".64" in op else 1
                writes += any(r in regs for r in range(
                    int(d.group(1)), int(d.group(1)) + width))
        found[f"Dh={m.group(1)} split={m.group(2)}"] = {
            "q_registers": f"R{min(regs)}..R{max(regs)}",
            "writes_in_loop": writes}
    return found


def build_variant():
    from dynamo_tpu_torch.ops.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "prefill_sm90.cu"
    src.write_text(variant_source((build.CSRC / "prefill_sm90.cu").read_text()))
    (OUT / "sm90.cuh").write_text((build.CSRC / "sm90.cuh").read_text())
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in ([build._nvcc(), *build.NVCC_FLAGS, "-o",
                          str(OUT / "libprefill_qreg.so"), str(src)],
                         [build._nvcc(), *arch, "-cubin", "-o",
                          str(OUT / "prefill_qreg.cubin"), str(src)])]
    build.build_all()          # the repository's kernels, meanwhile
    for p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the variant:\n{text}")
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(OUT / "prefill_qreg.cubin")],
                          capture_output=True, text=True, check=True).stdout
    lib = ctypes.CDLL(str(OUT / "libprefill_qreg.so"))
    for fn, argtypes in build.SIGNATURES["prefill_sm90"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib, q_register_writes(sass)


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    import chip_smoke as cs
    from dynamo_tpu_torch.ops.kernels import build
    from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error
    from dynamo_tpu_torch.ops.kernels.prefill import (
        paged_prefill_attention_stacked, paged_prefill_plain)
    from dynamo_tpu_torch.ops.kernels.ragged import (
        ragged_mixed_attention_stacked)
    variant, writes = build_variant()
    log(f"[sass] register-Q variant: {json.dumps(writes)}")
    libs = {"repo": build.library("prefill_sm90"), "register_q": variant}
    fns = {"paged_prefill": paged_prefill_attention_stacked,
           "ragged_mixed": ragged_mixed_attention_stacked}
    ok = True
    for name, label, case, _S, _d in cs.kernel_cases(
            np.random.default_rng(0)):
        if name not in fns or case["dh"] not in (64, 128):
            continue
        kw = dict(window=case["window"], softcap=case["softcap"])

        def run(layer, fn=fns[name], case=case, kw=kw):
            return fn(case["q"], case["pages"], layer, case["table"],
                      case["positions"], case["total"], case["sm_scale"],
                      **kw)

        ref = paged_prefill_plain(case["q"], case["pages"], 1, case["table"],
                                  case["positions"], case["total"],
                                  case["sm_scale"], **kw)
        real = torch.zeros(ref.shape[:2], dtype=torch.bool, device="cuda")
        for i, ql in enumerate(case["q_lens"]):
            real[i, :ql] = True
        row = {"kernel": name, "label": label, "dh": case["dh"]}
        outs = {}
        for tag, lib in libs.items():
            build._libs["prefill_sm90"] = lib
            outs[tag] = run(1)
            torch.cuda.synchronize()
            row[f"ulps_{tag}"] = float(row_ulp_error(outs[tag], ref)[real].max())
        row["bit_equal"] = bool(torch.equal(outs["repo"], outs["register_q"]))
        ok &= row["ulps_repo"] <= cs.KERNEL_TOL_ULPS
        if case["dh"] == 128:
            t = {"repo": [], "register_q": []}
            for tag in ("repo", "register_q", "register_q", "repo"):
                build._libs["prefill_sm90"] = libs[tag]
                t[tag].append(cs.time_ms(run, case["layers"]))
            row.update({f"ms_{k}": float(np.mean(v)) for k, v in t.items()})
        build._libs["prefill_sm90"] = libs["repo"]
        log(json.dumps(row))
        del case, outs
    log(cs.smi_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
