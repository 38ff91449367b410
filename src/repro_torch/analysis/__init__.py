"""Engine invariant analyzer of the port, counterpart of ``repro.analysis``.

Four pass families behind one :class:`AnalysisPass` protocol and one entry
point, :func:`run_analysis` (CLI: ``python -m repro_torch.analysis``):

1. **Op-stream passes** (:mod:`repro_torch.analysis.passes`) — run real
   engine entry points under the op recorder of
   :mod:`repro_torch.analysis.op_walk` and walk the aten op streams:
   ``dispatch-purity``, ``promotion-check``, ``collective-budget``;
   ``executable-budget`` (N/A: the port compiles nothing per
   configuration) records a note.
2. **Cost passes** (:mod:`repro_torch.analysis.cost_passes`, on the cost
   model of :mod:`repro_torch.analysis.cost_model`):
   ``cost-dispatch-scaling``, ``cost-collective-bytes``,
   ``cost-update-amortization``, ``cost-memory-footprint``.
3. **Plan validator** (:mod:`repro_torch.analysis.plan_check`) —
   structural checks over real plans of every strategy × ``kv_buckets ∈
   {1, 2, 3}``; also the opt-in hook behind ``EngineConfig.validate_plans``
   / ``REPRO_VALIDATE_PLANS=1``.
4. **Source lint** (:mod:`repro_torch.analysis.source_lint`) — repo-rule
   AST checks over ``src/repro_torch``.

The geometry.  Every pass runs the engine for real (a record is not an
abstract trace), on ``ctx.device``: the card by default, the CPU when asked
(each kernel wrapper then runs its plain version, inside the same named
region).  The geometry is one the built kernels accept: ``B, H, N = 1, 2,
128``, head_dim 32, d_model 64, blocks 16/16, pool 32 (the reference's
head_dim 16 cannot launch); the serving-tick passes run the flux-mmdit
smoke config (3 layers, d_model 64, 2 heads of 32).  The mesh combos (seq
and head mesh ``(1, 2)``: the mesh half of ``dispatch-purity`` and of the
cost groups, ``collective-budget``, ``cost-collective-bytes``) run in a
``torch.distributed`` world of two ranks (``torchrun --nproc-per-node 2
-m repro_torch.analysis``); in one process they are noted skips.

Adding a pass: a class with a ``name`` and ``run(ctx) -> list[Finding]``
(``ctx.note(msg)`` records a diagnostic that does not fail), appended to
:func:`ALL_PASSES`.

A new DispatchPlan field is threaded through three places, and the
analyzer enforces each: produced on the build path (``plan-rebuild-
coverage`` lint); an id field (suffix ``_ids``/``_slots``/``_src``/
``_rows``/``_idx``, or ``bkt_head``) listed in ``plan._ID_FIELDS`` so
``widen()`` restores int32 (``plan-widen-coverage`` lint, and the
validator's no-int16-after-widen check); and its core rank registered in
``plan_check._CORE_RANK``.  The fourth place, its logical spec in
``models/dit.engine_state_specs``, is the ``plan-spec-coverage`` lint's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol

__all__ = ["Finding", "AnalysisContext", "AnalysisPass", "PlanValidator", "SourceLint",
           "ALL_PASSES", "run_analysis"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation. ``where`` names the entry point or source
    location; ``rule`` is the stable machine-readable rule id."""

    pass_name: str
    rule: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.pass_name}/{self.rule}] {self.where}: {self.message}"


@dataclasses.dataclass
class AnalysisContext:
    """Shared pass inputs: the source root, the device the engine runs on,
    and a sink for notes that do not fail."""

    src_root: str
    device: str = "cuda"
    notes: List[str] = dataclasses.field(default_factory=list)

    def note(self, msg: str) -> None:
        self.notes.append(msg)


class AnalysisPass(Protocol):
    name: str

    def run(self, ctx: AnalysisContext) -> List[Finding]: ...


class SourceLint:
    """Adapter exposing :mod:`source_lint` through the pass protocol."""

    name = "source-lint"

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        from repro_torch.analysis.source_lint import lint_sources
        return [Finding(self.name, rule, f"{path}:{line}", msg)
                for path, line, rule, msg in lint_sources(ctx.src_root)]


class PlanValidator:
    """:func:`plan_check.check_plan` over real Update plans of every
    registered strategy × ``kv_buckets ∈ {1, 2, 3}`` (the plan is built
    before Dispatch, so one backend covers both)."""

    name = "plan-validator"

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        from repro_torch.analysis.passes import _N, _engine_cfg
        from repro_torch.analysis.plan_check import check_plan
        from repro_torch.core.strategy import available_strategies
        findings = []
        for strat in available_strategies():
            for kvb in (1, 2, 3):
                cfg = _engine_cfg(strategy=strat, kv_buckets=kvb)
                plan = self.plan(cfg, ctx.device)
                label = f"{strat}/kv_buckets={kvb}"
                findings += [Finding(self.name, "plan-invariant", f"update_layer[{label}]", m)
                             for m in check_plan(plan, cfg, _N)]
        return findings

    @staticmethod
    def plan(cfg, device):
        """The plan an Update of the analyzer's layer builds under ``cfg``."""
        from repro_torch.analysis.passes import (_B, _DH, _DM, _H, _N, _N_TEXT, _params,
                                                 _x)
        from repro_torch.core.engine import init_layer_state, update_layer
        state = init_layer_state(_B, _H, _N, _DM, _DH, cfg, device)
        _, st = update_layer(_params(device), _x(device, seed=1), state, cfg, n_text=_N_TEXT,
                             heads=_H, step_idx=2, num_steps=8)
        return st.plan


def ALL_PASSES() -> list:
    """Every pass, op-stream passes first (their records are memoized for
    the cost passes)."""
    from repro_torch.analysis.cost_passes import COST_PASSES
    from repro_torch.analysis.passes import OP_PASSES
    return [cls() for cls in OP_PASSES] + [cls() for cls in COST_PASSES] + [
        PlanValidator(), SourceLint()]


def _check_device(device: str) -> None:
    import torch
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("the analyzer runs the engine on the card by default, and no CUDA "
                           "device is available: pass device='cpu' (--device cpu) to run "
                           "the plain versions on the CPU")


def run_analysis(passes: Optional[list] = None, src_root: Optional[str] = None,
                 device: str = "cuda", verbose: bool = True) -> List[Finding]:
    """Run ``passes`` (default: all) on ``device`` and return every finding."""
    import os
    _check_device(device)
    if src_root is None:
        src_root = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", ".."))
    ctx = AnalysisContext(src_root=src_root, device=str(device))
    findings: List[Finding] = []
    for p in (ALL_PASSES() if passes is None else passes):
        got = p.run(ctx)
        findings.extend(got)
        if verbose:
            print(f"  pass {p.name}: {'OK' if not got else f'{len(got)} finding(s)'}")
    if verbose:
        for n in ctx.notes:
            print(f"  note: {n}")
        for f in findings:
            print(f"  {f}")
    return findings
