"""Workload forge: trace-driven open-loop scenario generation, the port's
own copy of the reference's (the compiled trace is byte-identical for
the same spec).

A ``WorkloadSpec`` describes a population (arrival mixture: Poisson,
diurnal or burst; zipf prefix families; multi-turn sessions; tenants
with heavy-tailed budgets; an SLO-tier mix and a model mix) and
``compile_workload`` lowers it to one canonical seeded trace file. The
file is the contract:

  - DETERMINISTIC: the same spec (same seed) compiles to a byte-identical
    file, always; no wall clock, process state or dict order joins the
    generation, so every replay issues the identical request stream.
  - OPEN-LOOP: every request carries its scheduled arrival offset, so a
    replay issues at trace time whatever the response latency (no
    coordinated omission).
  - CHEAP AT SCALE: a logical client is a line in the trace, not a
    thread; thousands of sessions replay from a few driver threads
    (``replay`` below).

File format (text, one request per line, sorted by arrival):

    #brpc-workload v1
    #spec {canonical-json of the spec}
    #tenant <name> budget=<tokens_per_s>        (one per tenant)
    <t_ms> <session> <turn> <tenant> <tier> <model> <max_new> <t1,t2,..>

Everything the serving stack needs to admit, route, and attribute a
request — tenant, SLO tier, model id, prompt tokens — is on its line;
the replay driver is a dumb clock.
"""

from __future__ import annotations

import io
import json
import math
import random
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

FORMAT_HEADER = "#brpc-workload v1"

# The SLO-tier names, cheapest-to-shed first. They map onto the serving
# stack's two lanes (interactive+standard ride the interactive lane,
# batch rides the batch lane) but shed at three distinct pressure
# thresholds — see DisaggRouter.
TIERS = ("interactive", "standard", "batch")


@dataclass(frozen=True)
class WorkloadSpec:
    """A traffic scenario, fully described. Every field joins the seed in
    the compiled file's #spec header, so two files are byte-identical iff
    their specs are equal."""

    name: str = "forge"
    seed: int = 0
    # ---- arrival process (session starts, open-loop) -----------------
    duration_s: float = 6.0
    sessions: int = 600          # logical clients (one session each)
    arrival: str = "poisson"     # "poisson" | "diurnal" | "burst"
    diurnal_amplitude: float = 0.6   # rate swing, 0..1 (diurnal)
    diurnal_period_s: float = 4.0
    burst_at_frac: float = 0.5       # burst window start, as duration frac
    burst_len_frac: float = 0.15     # burst window length, as duration frac
    burst_factor: float = 4.0        # rate multiplier inside the window
    # ---- multi-turn sessions -----------------------------------------
    turns: Tuple[int, int] = (1, 3)      # per-session turn count range
    think_time_s: Tuple[float, float] = (0.1, 0.8)  # inter-turn gap range
    # ---- prompt shape ------------------------------------------------
    prefix_families: int = 16     # zipf-shared prompt prefixes
    prefix_zipf_a: float = 1.3    # family popularity skew (>1, heavier=lower)
    prefix_tokens: int = 24       # shared-prefix length
    turn_tokens: Tuple[int, int] = (4, 16)   # fresh tokens added per turn
    max_prompt_tokens: int = 120  # hard cap (serving max_prompt guard)
    max_new: Tuple[int, int] = (3, 8)
    vocab: int = 256
    # ---- populations -------------------------------------------------
    tenants: int = 8
    tenant_budget_alpha: float = 1.1   # heavy tail: budget_i ~ i^-alpha
    tenant_base_budget: float = 600.0  # tokens/s for the largest tenant
    tier_mix: Tuple[Tuple[str, float], ...] = (
        ("interactive", 0.5), ("standard", 0.3), ("batch", 0.2))
    model_mix: Tuple[Tuple[str, float], ...] = (("", 1.0),)

    def canonical_json(self) -> str:
        d = asdict(self)
        return json.dumps(d, sort_keys=True, separators=(",", ":"))


@dataclass
class Request:
    """One line of the trace: a scheduled arrival with everything the
    serving stack needs."""

    t_ms: int
    session: int
    turn: int
    tenant: str
    tier: str
    model: str
    max_new: int
    prompt: Tuple[int, ...]

    def to_line(self) -> str:
        toks = ",".join(str(t) for t in self.prompt)
        return (f"{self.t_ms} {self.session} {self.turn} {self.tenant} "
                f"{self.tier} {self.model or '-'} {self.max_new} {toks}")

    @classmethod
    def from_line(cls, line: str) -> "Request":
        f = line.split()
        if len(f) != 8:
            raise ValueError(f"malformed workload line: {line!r}")
        model = "" if f[5] == "-" else f[5]
        prompt = tuple(int(t) for t in f[7].split(","))
        return cls(t_ms=int(f[0]), session=int(f[1]), turn=int(f[2]),
                   tenant=f[3], tier=f[4], model=model,
                   max_new=int(f[6]), prompt=prompt)


# ---- spec -> trace ----------------------------------------------------------

def _zipf_pick(rng: random.Random, n: int, a: float) -> int:
    """Zipf-distributed index in [0, n) via inverse CDF over exact
    normalized weights (n is small; no rejection sampling, fully
    deterministic in the rng stream: exactly one random() per pick)."""
    weights = [1.0 / (i + 1) ** a for i in range(n)]
    total = sum(weights)
    u = rng.random() * total
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if u <= acc:
            return i
    return n - 1


def _weighted_pick(rng: random.Random, mix: Sequence[Tuple[str, float]]):
    total = sum(w for _, w in mix)
    u = rng.random() * total
    acc = 0.0
    for name, w in mix:
        acc += w
        if u <= acc:
            return name
    return mix[-1][0]


def _intensity(spec: WorkloadSpec, t: float) -> float:
    """Relative arrival intensity at time t (unnormalized; session starts
    are drawn from this shape by inverse-CDF sampling)."""
    if spec.arrival == "diurnal":
        return max(1.0 + spec.diurnal_amplitude
                   * math.sin(2 * math.pi * t / spec.diurnal_period_s
                              - math.pi / 2), 0.05)
    if spec.arrival == "burst":
        b0 = spec.burst_at_frac * spec.duration_s
        b1 = b0 + spec.burst_len_frac * spec.duration_s
        return spec.burst_factor if b0 <= t < b1 else 1.0
    return 1.0  # poisson: homogeneous


def _start_times(spec: WorkloadSpec, rng: random.Random) -> List[float]:
    """``spec.sessions`` session start offsets in [0, duration), drawn
    from the arrival shape by inverse-CDF over a fine cumulative-intensity
    table — deterministic and exact enough at dt=duration/512."""
    steps = 512
    dt = spec.duration_s / steps
    cum = [0.0]
    for i in range(steps):
        cum.append(cum[-1] + _intensity(spec, (i + 0.5) * dt) * dt)
    total = cum[-1]
    out = []
    for _ in range(spec.sessions):
        u = rng.random() * total
        # binary search the table, linear-interpolate inside the cell
        lo, hi = 0, steps
        while lo < hi:
            mid = (lo + hi) // 2
            if cum[mid + 1] < u:
                lo = mid + 1
            else:
                hi = mid
        cell = cum[lo + 1] - cum[lo]
        frac = (u - cum[lo]) / cell if cell > 0 else 0.0
        out.append((lo + frac) * dt)
    return out


def tenant_budgets(spec: WorkloadSpec) -> Dict[str, float]:
    """tenant name -> token budget (tokens/s), heavy-tailed: tenant t0
    gets the base budget, tenant ti gets base * (i+1)^-alpha — a few
    whales and a long tail of small tenants, the population shape the
    per-tenant governor has to keep starvation-free."""
    return {f"t{i}": spec.tenant_base_budget / (i + 1) ** spec.tenant_budget_alpha
            for i in range(spec.tenants)}


def compile_workload(spec: WorkloadSpec) -> str:
    """Lower a spec to the canonical trace text. Pure function of the
    spec: one seeded rng drives every draw in a fixed order, the request
    list is sorted by (t_ms, session, turn), and floats never reach the
    output (times are integer ms) — byte-identical across runs, machines,
    and Python hash seeds."""
    rng = random.Random(spec.seed)
    # Prefix families are per (family, model): two models never share a
    # prompt prefix byte-for-byte, so cross-model KV reuse is impossible
    # at the source (the tiers are also collision-safe downstream).
    models = [m for m, _ in spec.model_mix]
    fam_tokens: Dict[Tuple[str, int], Tuple[int, ...]] = {}
    for model in models:
        for fam in range(spec.prefix_families):
            frng = random.Random((spec.seed, "family", model, fam).__repr__())
            fam_tokens[(model, fam)] = tuple(
                frng.randrange(1, spec.vocab) for _ in range(spec.prefix_tokens))

    starts = _start_times(spec, rng)
    reqs: List[Request] = []
    for sid, t0 in enumerate(starts):
        tenant = f"t{_zipf_pick(rng, spec.tenants, spec.tenant_budget_alpha)}"
        tier = _weighted_pick(rng, spec.tier_mix)
        model = _weighted_pick(rng, spec.model_mix)
        fam = _zipf_pick(rng, spec.prefix_families, spec.prefix_zipf_a)
        n_turns = rng.randint(*spec.turns)
        prompt = list(fam_tokens[(model, fam)])
        t = t0
        for turn in range(n_turns):
            fresh = rng.randint(*spec.turn_tokens)
            prompt += [rng.randrange(1, spec.vocab) for _ in range(fresh)]
            if len(prompt) > spec.max_prompt_tokens:
                del prompt[spec.max_prompt_tokens:]
            reqs.append(Request(
                t_ms=int(t * 1000), session=sid, turn=turn, tenant=tenant,
                tier=tier, model=model,
                max_new=rng.randint(*spec.max_new),
                prompt=tuple(prompt)))
            t += rng.uniform(*spec.think_time_s)

    reqs.sort(key=lambda r: (r.t_ms, r.session, r.turn))
    out = io.StringIO()
    out.write(FORMAT_HEADER + "\n")
    out.write("#spec " + spec.canonical_json() + "\n")
    for name, budget in sorted(tenant_budgets(spec).items()):
        out.write(f"#tenant {name} budget={budget:.3f}\n")
    for r in reqs:
        out.write(r.to_line() + "\n")
    return out.getvalue()


def write_workload(spec: WorkloadSpec, path: str) -> str:
    text = compile_workload(spec)
    with open(path, "w") as f:
        f.write(text)
    return path


def load_workload(text_or_path: str):
    """Parse a compiled trace -> (spec_dict, tenant_budgets, [Request]).
    Accepts the trace text itself or a path to it."""
    if text_or_path.startswith(FORMAT_HEADER):
        text = text_or_path
    else:
        with open(text_or_path) as f:
            text = f.read()
    lines = text.splitlines()
    if not lines or lines[0] != FORMAT_HEADER:
        raise ValueError("not a brpc-workload v1 file")
    spec_dict: dict = {}
    budgets: Dict[str, float] = {}
    reqs: List[Request] = []
    for line in lines[1:]:
        if not line:
            continue
        if line.startswith("#spec "):
            spec_dict = json.loads(line[len("#spec "):])
        elif line.startswith("#tenant "):
            f = line.split()
            budgets[f[1]] = float(f[2].split("=", 1)[1])
        elif not line.startswith("#"):
            reqs.append(Request.from_line(line))
    return spec_dict, budgets, reqs


# ---- replay -----------------------------------------------------------------

class ReplayStats:
    """Per-tier/per-tenant outcome accounting one replay accumulates.
    Thread-safe; the verdict legs read it after the drivers join."""

    def __init__(self):
        self._mu = threading.Lock()
        self.issued = 0
        self.late_ms_max = 0.0
        self.by_tier: Dict[str, dict] = {}
        self.by_tenant: Dict[str, dict] = {}
        self.by_model: Dict[str, dict] = {}

    @staticmethod
    def _cell() -> dict:
        return {"n": 0, "ok": 0, "shed": 0, "shed_with_hint": 0,
                "errors": 0, "hung": 0, "good_tokens": 0, "ttfts": []}

    def _note(self, table: dict, key: str, kind: str, tokens: int,
              ttft_s: Optional[float], hinted: bool) -> None:
        c = table.setdefault(key, self._cell())
        c["n"] += 1
        c[kind] += 1
        if kind == "shed" and hinted:
            c["shed_with_hint"] += 1
        c["good_tokens"] += tokens
        if ttft_s is not None:
            c["ttfts"].append(ttft_s)

    def note(self, req: Request, kind: str, tokens: int = 0,
             ttft_s: Optional[float] = None, hinted: bool = False) -> None:
        assert kind in ("ok", "shed", "errors", "hung")
        with self._mu:
            self.issued += 1
            self._note(self.by_tier, req.tier, kind, tokens, ttft_s, hinted)
            self._note(self.by_tenant, req.tenant, kind, tokens, ttft_s,
                       hinted)
            self._note(self.by_model, req.model or "-", kind, tokens,
                       ttft_s, hinted)

    def note_late(self, ms: float) -> None:
        with self._mu:
            self.late_ms_max = max(self.late_ms_max, ms)

    def snapshot(self) -> dict:
        """Deep-copied tables, safe to read after (or during) a replay."""
        with self._mu:
            def render(table: Dict[str, dict]) -> Dict[str, dict]:
                return {k: dict(c, ttfts=list(c["ttfts"]))
                        for k, c in table.items()}
            return {"issued": self.issued,
                    "late_ms_max": self.late_ms_max,
                    "by_tier": render(self.by_tier),
                    "by_tenant": render(self.by_tenant),
                    "by_model": render(self.by_model)}


def replay(reqs: Sequence[Request],
           issue: Callable[[Request, ReplayStats], None], *,
           drivers: int = 16, speed: float = 1.0,
           stats: Optional[ReplayStats] = None) -> ReplayStats:
    """Open-loop replay: issue every request at its scheduled trace time
    (scaled by 1/speed), from a bounded driver pool. ``issue`` runs one
    request end-to-end and records its outcome on ``stats``; drivers pull
    the next due request off the shared schedule, so thousands of logical
    sessions need only enough threads to cover the concurrency the trace
    actually produces. The arrival clock NEVER waits for a response —
    coordinated omission stays impossible by construction."""
    st = stats if stats is not None else ReplayStats()
    ordered = sorted(reqs, key=lambda r: (r.t_ms, r.session, r.turn))
    idx = [0]
    mu = threading.Lock()
    t0 = time.monotonic()

    def driver():
        while True:
            with mu:
                i = idx[0]
                if i >= len(ordered):
                    return
                idx[0] += 1
            r = ordered[i]
            due = t0 + (r.t_ms / 1000.0) / max(speed, 1e-9)
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                st.note_late(-delay * 1000.0)
            issue(r, st)

    threads = [threading.Thread(target=driver, daemon=True,
                                name=f"replay-{i}")
               for i in range(drivers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return st


def pct(vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile."""
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(int(len(s) * q), len(s) - 1)]
