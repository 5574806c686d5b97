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

Single-device replicas (``build(devices=...)``) live in one process: each
replica's device work is the single-device path, stepped in turn from this
loop. Replicas on one card share the weights' tensors (``.to`` of a tensor
already there is the tensor itself) and each holds its own pool.

Replicas of tensor-parallel groups (dp x tp, ``build(meshes=mesh)`` with a
``{"dp": n, "tp": tp}`` mesh, JAX's list of disjoint tp sub-meshes) are
SPMD: every rank builds the ``ContinuousBatcher`` of its dp coordinate over
its replica's tp sub-mesh (``parallel.mesh.replica_mesh``). JAX needs no
front end, since one controller drives every replica; the port puts one on
rank 0. The caller on rank 0 alone calls the surface above; every other
rank runs ``follow()`` until rank 0 calls ``close()``. The front end is the
same ``ReplicatedEngine``, over one ``_ReplicaView`` per replica in place of
an ``Engine``: it routes by the same rules on each replica's own loads
(queued tickets plus occupied rows, reported by its tp rank 0 after every
round), and ``ReplicaRounds`` carries the rounds. A submit waits on rank 0
for the next round; a round sends every rank the operations since the
last one over a gloo group of its own (``control_group``): each rank
applies its replica's, the replicas step, and the replicas' tp rank 0s
report their new tokens, finish reasons, errors, logprobs and loads back
to rank 0. A rank that fails fails the run (no error is kept per ticket
across ranks: ROADMAP Queue 3).
"""

from __future__ import annotations

import hashlib
import time
from contextlib import nullcontext

import numpy as np
import torch
import torch.distributed as dist

from bee_code_interpreter_tpu_torch.device import resolve_device
from bee_code_interpreter_tpu_torch.models.engine import (
    Engine,
    stream_chunk,
    stream_holdback,
)
from bee_code_interpreter_tpu_torch.models.serving import (
    ContinuousBatcher,
    SamplingParams,
)
from bee_code_interpreter_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    control_group,
    replica_mesh,
)


def route_order(loads: list[int], prompt: np.ndarray, page_size: int,
                prefix_affinity: bool, affinity_slack: int) -> list[int]:
    """Replica indices in routing-preference order: least outstanding
    first (the affinity-preferred one first while within the slack);
    later entries are the fallbacks when a replica's queue bound
    rejects."""
    order = sorted(range(len(loads)), key=lambda i: loads[i])
    if prefix_affinity:
        digest = hashlib.blake2b(
            prompt[:page_size].tobytes(), digest_size=8
        ).digest()
        preferred = int.from_bytes(digest, "big") % len(loads)
        if loads[preferred] <= loads[order[0]] + affinity_slack:
            order.remove(preferred)
            order.insert(0, preferred)
    return order


def params_to(tree, device: torch.device):
    """A parameter tree (dicts, lists, tensors) on ``device``; leaves
    already there are kept as they are, not copied."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


class ReplicatedEngine:
    """The router over ``engines``: ``Engine`` replicas in this process,
    or, with ``rounds`` (``over_mesh``), one ``_ReplicaView`` per dp x tp
    replica of a mesh, which the front end on rank 0 serves."""

    def __init__(
        self,
        engines: list,
        prefix_affinity: bool = False,
        affinity_slack: int = 4,
        rounds: "ReplicaRounds | None" = None,
    ) -> None:
        if not engines:
            raise ValueError("need at least one engine replica")
        self.engines = engines
        self.prefix_affinity = prefix_affinity
        self.affinity_slack = affinity_slack
        self.rounds = rounds
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
        """N fresh replicas from one copy of the params.

        ``devices`` places single-device replica i on ``devices[i]``; the
        default is ``cuda:0`` .. ``cuda:{n-1}``, which raises ValueError
        when fewer cards are visible (none without CUDA): the CPU, or
        several replicas on one card, are taken only when named.

        ``meshes`` is a ``{"dp": n_replicas, "tp": tp}`` mesh
        (``parallel.make_mesh``) whose every rank calls this alike: replica
        i is the tp group at dp coordinate i (``over_mesh``: rank 0 serves,
        the others ``follow()``); ``params`` are the full weights, anywhere,
        of which each rank keeps its shard."""
        if meshes is not None:
            if devices is not None:
                raise ValueError("give devices or meshes, not both")
            if axis_size(meshes, "dp") != n_replicas:
                raise ValueError(
                    f"{n_replicas} replicas need a mesh of dp={n_replicas}, "
                    f"got dp={axis_size(meshes, 'dp')}"
                )
            batcher = ContinuousBatcher(params, config,
                                        mesh=replica_mesh(meshes),
                                        **batcher_kw)
            return cls.over_mesh(Engine(batcher, max_queue=max_queue), meshes,
                                 prefix_affinity=prefix_affinity,
                                 affinity_slack=affinity_slack)
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

    @classmethod
    def over_mesh(cls, engine: Engine, mesh, prefix_affinity: bool = False,
                  affinity_slack: int = 4) -> "ReplicatedEngine":
        """dp x tp replicas from each rank's ``engine`` over its replica's
        tp sub-mesh (every rank of ``mesh`` calls this alike, with the same
        geometry and ``max_queue``)."""
        rounds = ReplicaRounds(engine, mesh)
        return cls(rounds.views, prefix_affinity=prefix_affinity,
                   affinity_slack=affinity_slack, rounds=rounds)

    @property
    def is_front_end(self) -> bool:
        """Whether this process calls the surface (every rank but the
        followers of a mesh)."""
        return self.rounds is None or self.rounds.is_front_end

    def follow(self) -> None:
        """Serve the front end's rounds until it closes the engine (the
        ranks of a mesh other than rank 0 call this instead of the
        surface)."""
        if self.rounds is None:
            raise RuntimeError("follow() serves a mesh's replicas")
        self.rounds.follow()

    def close(self) -> None:
        """End every rank's ``follow()`` (rank 0 of a mesh; once)."""
        if self.rounds is not None:
            self.rounds.close()

    def __enter__(self) -> "ReplicatedEngine":
        return self

    def __exit__(self, *exc) -> None:
        if self.is_front_end:
            self.close()

    # ------------------------------------------------------------- routing

    def _outstanding(self, i: int) -> int:
        return self.engines[i].outstanding

    def _route_order(self, prompt: np.ndarray) -> list[int]:
        loads = [self._outstanding(i) for i in range(len(self.engines))]
        return route_order(loads, prompt, self.engines[0].batcher.page_size,
                           self.prefix_affinity, self.affinity_slack)

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
        if self.rounds is not None:
            self.rounds.check_front("submit")
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
        device (the kernels launch on the current device's streams); over
        a mesh, one round."""
        if self.rounds is not None:
            self.rounds.exchange(step=True)
            return
        for engine in self.engines:
            device = engine.batcher.device
            with (torch.cuda.device(device) if device.type == "cuda"
                  else nullcontext()):
                engine.step()

    def run_to_completion(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.pending and not self.busy:
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
    def busy(self) -> bool:
        """Whether a replica is decoding or admitting (over a mesh, as of
        the last round)."""
        return any(engine.busy for engine in self.engines)

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


# the ticket accessors whose outcome (a value, or the exception raised) a
# replica's tp rank 0 reports to the front end, as its Engine answers them
_ACCESSORS = ("result", "result_logprobs", "finish_reason", "ticket_error")
_ERRORS = {"KeyError": KeyError, "RuntimeError": RuntimeError,
           "ValueError": ValueError}


def _outcome(call):
    """``("ok", value)`` of ``call()``, or ``("error", type, message)``."""
    try:
        return ("ok", call())
    except Exception as e:  # noqa: BLE001 - the front end re-raises it
        return ("error", type(e).__name__, e.args[0] if e.args else str(e))


def _reraise(outcome):
    if outcome[0] == "ok":
        return outcome[1]
    raise _ERRORS.get(outcome[1], RuntimeError)(outcome[2])


class ReplicaRounds:
    """The rounds of dp x tp replicas (the module docstring). Every rank of
    ``mesh`` holds one, over its replica's ``engine``; rank 0's
    ``ReplicatedEngine`` calls ``exchange``, the others ``follow()`` until
    ``close()``.

    A round is one broadcast from rank 0 (the operations since the last
    round, whether to step, and whose stats to report) and one gather of
    the replicas' reports, which update the ``views``. ``exchange_ms``
    holds rank 0's time in each round's broadcast and gather, less the time
    it waits for the slowest replica's step."""

    def __init__(self, engine: Engine, mesh) -> None:
        self.engine = engine
        self.replica = axis_index(mesh, "dp")
        self.is_leader = axis_index(mesh, "tp") == 0
        self._group = control_group(mesh)
        self._front_rank = int(mesh.mesh.flatten()[0])
        self.is_front_end = dist.get_rank() == self._front_rank
        self._closed = False
        self.exchange_ms: list[float] = []
        self.views = [_ReplicaView(self, i)
                      for i in range(axis_size(mesh, "dp"))]
        self._outbox: list[tuple] = []
        # a leader's view of what it last reported, per local ticket
        self._reported: dict[int, tuple] = {}

    def check_front(self, what: str) -> None:
        if not self.is_front_end:
            raise RuntimeError(
                f"{what}: only rank {self._front_rank}'s front end serves; "
                "this rank runs follow()"
            )
        if self._closed:
            raise RuntimeError(f"{what}: the engine is closed")

    def send(self, op: tuple) -> None:
        """Queue ``(kind, replica, local ticket, args)`` for the next
        round."""
        self._outbox.append(op)

    def exchange(self, step: bool, ops: tuple = (),
                 stats_of: int | None = None) -> list[dict]:
        """One round from rank 0: the queued operations and ``ops`` out, the
        reports in, the views updated. Returns the reports by replica."""
        self.check_front("a round")
        message = {"ops": self._outbox + list(ops), "step": step,
                   "stats": stats_of}
        self._outbox = []
        t0 = time.monotonic()
        dist.broadcast_object_list([message], src=self._front_rank,
                                   group=self._group)
        sent = time.monotonic() - t0
        reports = sorted((r for r in self._round(message) if r is not None),
                         key=lambda r: r["replica"])
        done = time.monotonic()
        slowest = max(r["ready"] for r in reports)
        self.exchange_ms.append((sent + max(0.0, done - slowest)) * 1e3)
        for rep in reports:
            self.views[rep["replica"]].update(rep)
        return reports

    def _round(self, message) -> list | None:
        """Apply this rank's part of a round; the reports, on rank 0."""
        outcomes = []
        for kind, replica, local, args in message["ops"]:
            if replica != self.replica:
                continue
            if kind == "submit":
                prompt, max_new_tokens, sampling, kw = args
                got = self.engine.submit(prompt, max_new_tokens,
                                         sampling=sampling, **kw)
                if got != local:
                    raise RuntimeError(
                        f"replica {self.replica} numbered a submit {got}, "
                        f"the front end {local}")
                self._reported.pop(local, None)
            else:
                op = getattr(self.engine, kind)  # cancel or release
                outcomes.append(_outcome(lambda: op(local)))
        if message["step"]:
            self.engine.step()
        report = (self._report(outcomes, message["stats"] == self.replica)
                  if self.is_leader else None)
        reports = [None] * dist.get_world_size(self._group) \
            if self.is_front_end else None
        dist.gather_object(report, reports, dst=self._front_rank,
                           group=self._group)
        return reports

    def _report(self, outcomes: list, stats: bool) -> dict:
        """A replica leader's report: its loads, each ticket whose state
        moved since the last report (the tokens new since then, the
        accessors' outcomes), and the outcomes of this round's cancels and
        releases."""
        engine, batcher = self.engine, self.engine.batcher
        tickets = {}
        for local, state in engine._state.items():
            partial = engine.partial_result(local)
            done = engine.is_done(local)
            kind = state if isinstance(state, str) else type(state).__name__
            key = (kind, len(partial), done)
            last = self._reported.get(local)
            if last == key:
                continue
            shown = 0 if last is None or last[1] > len(partial) else last[1]
            tickets[local] = {
                "done": done, "from": shown, "tokens": partial[shown:],
                **{name: _outcome(lambda f=getattr(engine, name): f(local))
                   for name in _ACCESSORS}}
            self._reported[local] = key
        return {
            "replica": self.replica, "ready": time.monotonic(),
            "loads": {"pending": engine.pending,
                      "active": int(batcher.active.sum()),
                      "prefilling": len(batcher.prefill_state),
                      "busy": batcher.busy},
            "tickets": tickets, "outcomes": outcomes,
            "stats": engine.stats if stats else None,
        }

    def follow(self) -> None:
        """Serve rank 0's rounds until it closes the engine."""
        if self.is_front_end:
            raise RuntimeError("rank 0 is the front end; it does not follow")
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=self._front_rank,
                                       group=self._group)
            if box[0] == "close":
                return
            self._round(box[0])

    def close(self) -> None:
        """End every rank's ``follow()`` (rank 0; once)."""
        if self.is_front_end and not self._closed:
            dist.broadcast_object_list(["close"], src=self._front_rank,
                                       group=self._group)
        self._closed = True


class _ReplicaView:
    """Replica ``index`` of a ``ReplicaRounds`` as rank 0 sees it: the part
    of the ``Engine`` surface that ``ReplicatedEngine`` calls, numbering
    the tickets as the replica's engine will. A submit validates on rank
    0's batcher (every replica has the same geometry), waits for the next
    round and counts at once in the loads, as JAX's controller sees its
    engine's queue grow; ``cancel``, ``release`` and ``stats`` make a round
    of their own; the reads answer from the replica's last report."""

    def __init__(self, rounds: ReplicaRounds, index: int) -> None:
        self._rounds = rounds
        self.index = index
        self.batcher = rounds.engine.batcher  # the shared geometry
        self.max_queue = rounds.engine.max_queue
        self.loads = {"pending": 0, "active": 0, "prefilling": 0,
                      "busy": False}
        self._next = 0
        self._records: dict[int, dict] = {}
        self._cursor: dict[int, int] = {}
        self._holdback: dict[int, int] = {}

    def update(self, report: dict) -> None:
        """Take in this replica's report of a round."""
        self.loads = report["loads"]
        for local, rec in report["tickets"].items():
            old = self._records.get(local, {"tokens": []})
            rec["tokens"] = old["tokens"][:rec.pop("from")] + rec["tokens"]
            self._records[local] = rec

    def submit(self, prompt, max_new_tokens: int,
               sampling: SamplingParams | None = None,
               prefill_chunk: int | None = None, adapter: int | None = None,
               priority: int = 0,
               interleave_admission: int | None = None) -> int:
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.batcher.validate_request(
            prompt, max_new_tokens, sampling=sampling, adapter=adapter,
            interleave_admission=interleave_admission,
            prefill_chunk=prefill_chunk)
        if self.max_queue is not None and self.pending >= self.max_queue:
            raise RuntimeError(f"queue full ({self.max_queue})")
        local = self._next
        self._next += 1
        kw = dict(prefill_chunk=prefill_chunk, adapter=adapter,
                  priority=priority,
                  interleave_admission=interleave_admission)
        self._rounds.send(("submit", self.index, local,
                           (prompt, max_new_tokens, sampling, kw)))
        self.loads["pending"] += 1
        queued = ("error", "RuntimeError", f"ticket {local} still queued")
        self._records[local] = {
            "done": False, "tokens": [], "result": queued,
            "result_logprobs": queued, "finish_reason": queued,
            "ticket_error": ("ok", None)}
        self._cursor[local] = 0
        self._holdback[local] = stream_holdback(sampling)
        return local

    @property
    def pending(self) -> int:
        return self.loads["pending"]

    @property
    def outstanding(self) -> int:
        return (self.loads["pending"] + self.loads["active"]
                + self.loads["prefilling"])

    @property
    def busy(self) -> bool:
        return self.loads["busy"]

    @property
    def stats(self) -> dict:
        """The replica's ``Engine.stats`` (a round)."""
        return self._rounds.exchange(step=False,
                                     stats_of=self.index)[self.index]["stats"]

    def _record(self, local: int) -> dict:
        self._rounds.check_front("a ticket read")
        return self._records[local]

    def is_done(self, local: int) -> bool:
        return self._record(local)["done"]

    def result(self, local: int) -> list[int]:
        return _reraise(self._record(local)["result"])

    def result_logprobs(self, local: int) -> list[float]:
        return _reraise(self._record(local)["result_logprobs"])

    def finish_reason(self, local: int) -> str:
        return _reraise(self._record(local)["finish_reason"])

    def ticket_error(self, local: int) -> str | None:
        return _reraise(self._record(local)["ticket_error"])

    def partial_result(self, local: int) -> list[int]:
        return list(self._record(local)["tokens"])

    def new_tokens(self, local: int) -> list[int]:
        tokens = self.partial_result(local)
        if not tokens:
            return []
        chunk, self._cursor[local] = stream_chunk(
            tokens, self.is_done(local), self._cursor[local],
            self._holdback[local])
        return chunk

    def _ticket_op(self, kind: str, local: int) -> None:
        reports = self._rounds.exchange(
            step=False, ops=((kind, self.index, local, None),))
        _reraise(reports[self.index]["outcomes"][-1])

    def cancel(self, local: int) -> None:
        self._ticket_op("cancel", local)

    def release(self, local: int) -> None:
        self._ticket_op("release", local)
        self._cursor.pop(local, None)
        self._holdback.pop(local, None)
