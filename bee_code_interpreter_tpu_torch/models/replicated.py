"""Data-parallel serving: a router over N engine replicas.

The counterpart of ``bee_code_interpreter_tpu/models/replicated.py``.
Tensor parallelism (``ContinuousBatcher(mesh=...)``) spreads one model
instance across cards; this module scales throughput with N independent
replicas, each its own ``Engine`` over its own batcher on its own device,
behind one submit / step / result surface.

Routing is the JAX engine's, rule for rule: least outstanding work (queued
tickets plus occupied rows) first; with ``prefix_affinity`` the first page
of a prompt hashes to a preferred replica, which wins while it is at most
``affinity_slack`` requests busier than the idlest, so repeat prompts land
where their prefix-cache pages live; a replica whose queue bound rejects a
request spills it to the next in order.

Host-side only, in one process: each replica's device work is the
single-device path, stepped in turn from this loop. Replicas on one card
share the weights' tensors (``.to`` of a tensor already there is the tensor
itself) and each holds its own pool. Replicas of tensor-parallel groups
(dp x tp, JAX's ``meshes=``) are not ported yet (ROADMAP Queue 1, item 4,
slice 12).
"""

from __future__ import annotations

import hashlib
from contextlib import nullcontext

import numpy as np
import torch

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.models.engine import Engine
from bee_code_interpreter_tpu_torch.models.serving import (
    ContinuousBatcher,
    SamplingParams,
)


def params_to(tree, device: torch.device):
    """A parameter tree (dicts, lists, tensors) on ``device``; leaves
    already there are kept as they are, not copied."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


class ReplicatedEngine:
    def __init__(
        self,
        engines: list[Engine],
        prefix_affinity: bool = False,
        affinity_slack: int = 4,
    ) -> None:
        if not engines:
            raise ValueError("need at least one engine replica")
        self.engines = engines
        self.prefix_affinity = prefix_affinity
        self.affinity_slack = affinity_slack
        self._ticket = 0
        self._submitted = 0  # monotonic, unlike the live-ticket map
        # global ticket -> (replica index, replica-local ticket)
        self._where: dict[int, tuple[int, int]] = {}

    # ------------------------------------------------------------ building

    @classmethod
    def build(
        cls,
        params,
        config,
        n_replicas: int,
        devices: list | None = None,
        meshes: list | None = None,
        prefix_affinity: bool = False,
        affinity_slack: int = 4,
        max_queue: int | None = None,
        **batcher_kw,
    ) -> "ReplicatedEngine":
        """N fresh single-device replicas from one copy of the params.

        ``devices`` places replica i on ``devices[i]``; the default is
        ``cuda:0`` .. ``cuda:{n-1}``, which raises ValueError when fewer
        cards are visible (none without CUDA): the CPU, or several replicas
        on one card, are taken only when named. ``meshes`` (dp x tp
        replicas) is not ported yet (ROADMAP Queue 1, item 4, slice 12)."""
        if meshes is not None:
            raise NotImplementedError(
                "replicas over tensor-parallel meshes (dp x tp) are not "
                "ported yet (ROADMAP Queue 1, item 4, slice 12)"
            )
        if devices is None:
            have = torch.cuda.device_count()
            if have < n_replicas:
                raise ValueError(
                    f"{n_replicas} replicas need {n_replicas} devices, "
                    f"have {have}"
                )
            devices = [f"cuda:{i}" for i in range(n_replicas)]
        if len(devices) != n_replicas:
            raise ValueError(
                f"got {len(devices)} devices for {n_replicas} replicas"
            )
        engines = []
        for device in devices:
            device = resolve_device(device)
            engines.append(Engine(
                ContinuousBatcher(params_to(params, device), config,
                                  device=device, **batcher_kw),
                max_queue=max_queue,
            ))
        return cls(
            engines,
            prefix_affinity=prefix_affinity,
            affinity_slack=affinity_slack,
        )

    # ------------------------------------------------------------- routing

    def _outstanding(self, i: int) -> int:
        # O(1): queue depth + occupied rows (Engine.stats would iterate
        # every ticket ever submitted)
        engine = self.engines[i]
        return (
            engine.pending
            + int(engine.batcher.active.sum())
            + len(engine.batcher.prefill_state)
        )

    def _route_order(self, prompt: np.ndarray) -> list[int]:
        """Replica indices in routing-preference order: least outstanding
        first (the affinity-preferred one first while within the slack);
        later entries are the fallbacks when a replica's queue bound
        rejects."""
        loads = [self._outstanding(i) for i in range(len(self.engines))]
        order = sorted(range(len(self.engines)), key=lambda i: loads[i])
        if self.prefix_affinity:
            page = self.engines[0].batcher.page_size
            digest = hashlib.blake2b(
                prompt[:page].tobytes(), digest_size=8
            ).digest()
            preferred = int.from_bytes(digest, "big") % len(self.engines)
            if loads[preferred] <= loads[order[0]] + self.affinity_slack:
                order.remove(preferred)
                order.insert(0, preferred)
        return order

    def _route(self, prompt: np.ndarray) -> int:
        return self._route_order(prompt)[0]

    # -------------------------------------------------------------- intake

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        sampling: SamplingParams | None = None,
        **engine_kwargs,
    ) -> int:
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        # a full queue on the routed replica must not reject a request
        # another replica could take: try in preference order (ValueError,
        # a validation failure, fails alike everywhere and propagates)
        last_full: RuntimeError | None = None
        for replica in self._route_order(prompt):
            try:
                local = self.engines[replica].submit(
                    prompt, max_new_tokens, sampling=sampling,
                    **engine_kwargs,
                )
            except RuntimeError as e:  # queue full on this replica
                last_full = e
                continue
            ticket = self._ticket
            self._ticket += 1
            self._where[ticket] = (replica, local)
            self._submitted += 1
            return ticket
        raise RuntimeError(
            f"every replica's queue is full ({last_full})"
        ) from last_full

    # --------------------------------------------------------------- step

    def step(self) -> None:
        """One step of every replica, each with its card as the current
        device (the kernels launch on the current device's streams)."""
        for engine in self.engines:
            device = engine.batcher.device
            with (torch.cuda.device(device) if device.type == "cuda"
                  else nullcontext()):
                engine.step()

    def run_to_completion(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if all(
                engine.pending == 0 and not engine.batcher.busy
                for engine in self.engines
            ):
                return
            self.step()
        raise RuntimeError("run_to_completion exceeded max_steps")

    # ------------------------------------------------------------- results

    def _local(self, ticket: int) -> tuple[Engine, int]:
        if ticket not in self._where:
            raise KeyError(f"unknown ticket {ticket}")
        replica, local = self._where[ticket]
        return self.engines[replica], local

    def replica_of(self, ticket: int) -> int:
        """Which replica a ticket landed on."""
        if ticket not in self._where:
            raise KeyError(f"unknown ticket {ticket}")
        return self._where[ticket][0]

    def is_done(self, ticket: int) -> bool:
        engine, local = self._local(ticket)
        return engine.is_done(local)

    def result(self, ticket: int) -> list[int]:
        engine, local = self._local(ticket)
        return engine.result(local)

    def result_logprobs(self, ticket: int) -> list[float]:
        engine, local = self._local(ticket)
        return engine.result_logprobs(local)

    def finish_reason(self, ticket: int) -> str:
        engine, local = self._local(ticket)
        return engine.finish_reason(local)

    def ticket_error(self, ticket: int) -> str | None:
        engine, local = self._local(ticket)
        return engine.ticket_error(local)

    def partial_result(self, ticket: int) -> list[int]:
        engine, local = self._local(ticket)
        return engine.partial_result(local)

    def new_tokens(self, ticket: int) -> list[int]:
        engine, local = self._local(ticket)
        return engine.new_tokens(local)

    def cancel(self, ticket: int) -> None:
        engine, local = self._local(ticket)
        engine.cancel(local)

    def release(self, ticket: int) -> None:
        engine, local = self._local(ticket)
        engine.release(local)
        del self._where[ticket]

    # -------------------------------------------------------------- stats

    @property
    def pending(self) -> int:
        return sum(engine.pending for engine in self.engines)

    @property
    def stats(self) -> dict:
        """Aggregate counters plus a per-replica breakdown."""
        per = [engine.stats for engine in self.engines]
        return {
            "replicas": len(per),
            "queued": sum(s["queued"] for s in per),
            "active_rows": sum(s["active_rows"] for s in per),
            "requests_submitted": self._submitted,  # monotonic
            "live_tickets": len(self._where),  # shrinks on release
            "per_replica": per,
        }
