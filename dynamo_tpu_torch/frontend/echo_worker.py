"""Echo test worker: registers a model served by the EchoEngine.

Parity in role with the reference's echo engines (``lib/llm/src/engines.rs``)
exposed as a worker process — used for frontend e2e tests without hardware.
"""

from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.engine.base import EchoEngine
from dynamo_tpu_torch.llm.register import register_llm, serve_engine
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime.runtime import DEFAULT_COORDINATOR, DistributedRuntime
from dynamo_tpu_torch.utils.logging import configure_logging
from dynamo_tpu_torch.utils.testing import make_test_card


async def amain(args: argparse.Namespace) -> None:
    drt = await DistributedRuntime.create(coordinator=args.coordinator)
    if args.model_path:
        card = ModelDeploymentCard.from_local_path(args.model_path,
                                                   name=args.model_name)
    else:
        card = make_test_card(name=args.model_name or "echo-model")
    endpoint = (drt.namespace(args.namespace).component(args.component)
                .endpoint("generate"))
    engine = EchoEngine(delay_s=args.token_delay)
    await serve_engine(endpoint, engine)
    await register_llm(drt, endpoint, card)
    print(f"echo worker serving model {card.name}", flush=True)
    try:
        await drt.runtime.wait_shutdown()
    finally:
        await drt.close()


def main() -> None:
    parser = argparse.ArgumentParser(description="dynamo_tpu echo worker")
    parser.add_argument("--coordinator", default=DEFAULT_COORDINATOR)
    parser.add_argument("--namespace", default="dynamo")
    parser.add_argument("--component", default="echo")
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--model-path", default=None,
                        help="HF-style local model dir (tokenizer/config)")
    parser.add_argument("--token-delay", type=float, default=0.0)
    args = parser.parse_args()
    configure_logging()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
