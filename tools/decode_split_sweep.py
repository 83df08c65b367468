"""Time the split-KV paged decode kernel over split lengths, on the GPU.

    python3 tools/decode_split_sweep.py [positions ...]

For decode batches like ``chip_smoke.py``'s phase 2 (B = 1, 8 and 32 rows,
contexts drawn up to 4096, Llama-3.2-3B heads, page 16, NaN in the
garbage page), sets ``decode.SPLIT_POSITIONS`` to each length (default
176 256 320 592 1024 2048 positions) and prints the split count the
wrapper then chooses, the kernel's device time per call
(``chip_smoke.time_ms``: layers cycled past the L2) and its row error
against the plain version. Needs one CUDA GPU; prints the card's name and
power limit first.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.ops.kernels import decode  # noqa: E402
from dynamo_tpu_torch.ops.kernels.plain import row_ulp_error  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_split_sweep: needs a CUDA GPU", file=sys.stderr)
        return 2
    lengths = [int(x) for x in sys.argv[1:]] or [176, 256, 320, 592, 1024,
                                                  2048]
    print(cs.smi_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    for B in (1, 8, 32):
        ctxs = [4096] + list(rng.integers(1, 4097, size=B - 1))
        if B > 2:
            ctxs[1] = 1
        case = cs.make_case(rng, B, [1] * B, ctxs, 1)
        q = case["q"][:, :1].contiguous()
        pos = case["positions"][:, :1].contiguous()

        def run(layer):
            return decode.paged_decode_attention_stacked(
                q, case["pages"], layer, case["table"], pos, case["total"],
                case["sm_scale"])
        ref = decode.paged_decode_plain(q, case["pages"], 1, case["table"],
                                        pos, case["total"], case["sm_scale"])
        nbytes, _ = cs.work_of(case, 1)
        for length in lengths:
            decode.SPLIT_POSITIONS = length
            splits = decode.decode_splits(B, cs.HKV, case["table"].shape[1],
                                          cs.PS, sms)
            err = float(row_ulp_error(run(1), ref).max())
            ms = cs.time_ms(run, case["layers"])
            print(f"B={B} split_positions={length} splits={splits} "
                  f"ms={ms:.4f} GB/s={nbytes / ms / 1e6:.0f} "
                  f"row_err={err:.3f} ulps", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
