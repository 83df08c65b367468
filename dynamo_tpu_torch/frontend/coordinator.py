"""Standalone coordinator process: ``python -m dynamo_tpu_torch.frontend.coordinator``."""

from __future__ import annotations

import argparse
import asyncio
import logging

from dynamo_tpu_torch.runtime.coordinator import Coordinator
from dynamo_tpu_torch.utils.logging import configure_logging


async def amain(args: argparse.Namespace) -> None:
    coord = await Coordinator(host=args.host, port=args.port).start()
    print(f"coordinator listening on {coord.address}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await coord.stop()


def main() -> None:
    parser = argparse.ArgumentParser(description="dynamo_tpu coordinator")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6650)
    args = parser.parse_args()
    configure_logging()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
