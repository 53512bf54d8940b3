"""Embedding sharding planner: a DP over device-memory x host-memory
bins, the table constraints and a bandwidth cost model.

Counterpart of torcheasyrec_tpu/parallel/planner.py (``_options``,
``create_plan``, ``plan_cost``, ``save_plan``/``load_plan``), with the
same options, the same DP and the same environment variables
(``INTRA_NODE_BANDWIDTH``, ``CROSS_NODE_BANDWIDTH``,
``HOST_LINK_BANDWIDTH``, ``HBM_BANDWIDTH``, ``HBM_CAPACITY``,
``DDR_CAPACITY``, ``STORAGE_RESERVE_PERCENT``,
``COLLECTIVE_LAUNCH_OVERHEAD``, ``HOST_LINK_LATENCY``), whose defaults
here are one H100's. For every table it estimates the seconds a step of
each layout costs (``row_wise``, ``column_wise``, ``table_wise``,
``table_row_wise``, ``data_parallel``, ``host_offload``) and the memory
each takes, and picks the plan of least total time that fits the
budgets. A table's ``embedding_constraints.sharding_types`` narrow its
options. The port's engine has no host-offloaded tables, so its model
build excludes every table from that option (``host_excluded``); the
option stays in the DP so that a plan equals the JAX package's on the
same inputs.
"""

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Set

from torcheasyrec_tpu_torch.parallel.emb_engine import (
    _HOST_OPT_KINDS,
    ALL_SHARDINGS,
    COLUMN_WISE,
    COMPAT_SHARDING,
    DATA_PARALLEL,
    HOST_OFFLOAD,
    ROW_WISE,
    TABLE_ROW_WISE,
    TABLE_WISE,
    TableSpec,
)

logger = logging.getLogger("tzrec_tpu_torch")

# One H100 SXM5 80GB and its host; each value can be overridden by the
# environment variable of its name, as in the reference
# (plan_util.py:111-114), and is read at call time. HBM_CAPACITY is the
# card's own memory where CUDA is present (``_hbm_capacity``).
_ENV_DEFAULTS = {
    # NVLink 4 between the cards of one host: 900 GB/s a card, both
    # directions together (H100 SXM5 datasheet), 450 GB/s each way
    "INTRA_NODE_BANDWIDTH": 4.5e11,  # B/s
    # between hosts: one 400 Gb/s ConnectX-7 port a card (DGX H100
    # datasheet), 50 GB/s
    "CROSS_NODE_BANDWIDTH": 5.0e10,  # B/s
    # PCIe Gen5 x16 between host and card: 64 GB/s each way
    "HOST_LINK_BANDWIDTH": 6.4e10,  # B/s
    # HBM3 (H100 SXM5 datasheet): 3.35 TB/s
    "HBM_BANDWIDTH": 3.35e12,  # B/s
    # HBM3 (H100 SXM5 datasheet): 80 GB
    "HBM_CAPACITY": 80e9,  # bytes
    "STORAGE_RESERVE_PERCENT": 0.15,
    # fixed launch/sync latency per collective: why tiny tables prefer
    # replication (1 grad allgather) over row_wise (3 tiny a2a's) even
    # though sharding moves fewer bytes
    "COLLECTIVE_LAUNCH_OVERHEAD": 5e-6,  # s
    # fixed host round-trip per step for the host_offload tier (H2D
    # staging + D2H row grads, dispatch + PCIe latency): why small
    # tables never offload — only capacity-driven spills pay this
    "HOST_LINK_LATENCY": 3e-5,  # s
}


def _env(name: str) -> float:
    if name == "HBM_CAPACITY" and name not in os.environ:
        return _hbm_capacity()
    return float(os.environ.get(name, _ENV_DEFAULTS[name]))


def _hbm_capacity() -> float:
    """The card's memory where CUDA is present, else the H100's 80 GB."""
    import torch

    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory)
    return _ENV_DEFAULTS["HBM_CAPACITY"]


class PlanError(ValueError):
    """No sharding plan satisfies the memory budgets / constraints."""




def _ddr_capacity() -> float:
    if "DDR_CAPACITY" in os.environ:
        return float(os.environ["DDR_CAPACITY"])
    try:
        return float(
            os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        )
    except (ValueError, OSError, AttributeError):
        return 64e9


_OPT_STATE_FACTOR = {
    "sgd": 0.0,
    "adagrad": 1.0,
    "rowwise_adagrad": 1.0 / 8,  # ~dim/1 rows; approximated per-row
    "adam": 2.0,
    "partial_rowwise_adam": 1.1,
    "lamb": 2.0,
    "partial_rowwise_lamb": 1.1,
    "lars_sgd": 1.0,
    "adadelta": 2.0,
    "rmsprop": 1.0,
}


@dataclasses.dataclass
class _Option:
    sharding: str
    time_cost: float  # seconds per step (estimate)
    mem_bytes: float  # per-device HBM bytes
    ddr_bytes: float = 0.0  # host-DDR bytes (host_offload tier)


def _wire_time(bytes_total: float, n_devices: int,
               shards_per_host: int) -> float:
    """Collective wire time: the fraction of ring traffic that crosses
    host-group boundaries rides DCN, the rest ICI."""
    n_hosts = max(n_devices // max(shards_per_host, 1), 1)
    if n_hosts <= 1:
        return bytes_total / _env("INTRA_NODE_BANDWIDTH")
    cross = bytes_total * (n_hosts - 1) / n_hosts
    return (bytes_total - cross) / _env("INTRA_NODE_BANDWIDTH") + cross / _env("CROSS_NODE_BANDWIDTH")


def _options(
    spec: TableSpec, n_devices: int, ids_per_step: float, opt_factor: float,
    shards_per_host: int = 1,
    allow_host: bool = True,
) -> List[_Option]:
    bytes_table = spec.rows * spec.dim * 4.0 * (1.0 + opt_factor)
    row_bytes = spec.dim * 4.0
    n = ids_per_step  # global ids per step for this table
    out = []
    n_hosts = max(n_devices // max(shards_per_host, 1), 1)
    lat = _env("COLLECTIVE_LAUNCH_OVERHEAD")
    if n_devices > 1:
        # row_wise: 3 a2a's (ids out, rows back, grad rows out) of this
        # device's LOCAL n/D ids — per-device wire bytes, the quantity
        # every link actually carries (using global n here overcounted
        # sharding by D and made replication look faster than row_wise
        # even for 40M-row tables)
        n_loc = n / n_devices
        wire = n_loc * (4.0 + 2.0 * row_bytes)
        comm = _wire_time(wire, n_devices, shards_per_host) + 3 * lat
        # each shard serves ~n/D gathers + n/D RMW updates
        hbm = (n_loc * row_bytes * 3.0) / _env("HBM_BANDWIDTH")
        out.append(_Option(ROW_WISE, comm + hbm, bytes_table / n_devices))
        # column_wise: every shard touches every id but only dim/D of
        # each row — same wire volume, small tie-break penalty so
        # row_wise wins at equal cost (CW's value is balancing hot rows
        # / huge dims, selectable via constraint or forced plan)
        if spec.dim % n_devices == 0:
            out.append(_Option(
                COLUMN_WISE, (comm + hbm) * 1.05, bytes_table / n_devices
            ))
        # table_wise: the owning shard serves ALL n ids' row traffic
        # (hot-spot on its HBM + its links, riding DCN from other hosts)
        tw_comm = (
            n * (4.0 + 2.0 * row_bytes)
        ) / (_env("CROSS_NODE_BANDWIDTH") if n_hosts > 1 else _env("INTRA_NODE_BANDWIDTH"))
        out.append(_Option(
            TABLE_WISE,
            tw_comm + 3 * lat
            + (n * row_bytes * 3.0) / _env("HBM_BANDWIDTH"),
            bytes_table,
        ))
        # table_row_wise: rows split over ONE host group — remote hosts'
        # ids/rows ride DCN to that group, the gather fans out on ICI
        if 1 < shards_per_host < n_devices:
            group_wire = n / shards_per_host * (4.0 + 2.0 * row_bytes)
            cross = group_wire * (n_hosts - 1) / n_hosts
            twrw_comm = cross / _env("CROSS_NODE_BANDWIDTH") + (
                group_wire - cross
            ) / _env("INTRA_NODE_BANDWIDTH")
            out.append(_Option(
                TABLE_ROW_WISE,
                twrw_comm + 3 * lat
                + (n / shards_per_host * row_bytes * 3.0)
                / _env("HBM_BANDWIDTH"),
                bytes_table / shards_per_host,
            ))
    # data_parallel: local gather of n/D ids; the update allgathers
    # every device's (ids, grads) and applies ALL n rows locally
    comm_dp = (
        _wire_time(n * (4.0 + row_bytes) * (n_devices - 1) / n_devices,
                   n_devices, shards_per_host) + lat
        if n_devices > 1 else 0.0
    )
    hbm_dp = (
        (n / n_devices + 2.0 * n) * row_bytes
    ) / _env("HBM_BANDWIDTH")
    out.append(_Option(DATA_PARALLEL, comm_dp + hbm_dp, bytes_table))
    if allow_host:
        # host_offload: batch rows H2D + row grads D2H over the host
        # link, plus the host-side gather/update (DDR ~ 0.5e11 B/s);
        # HBM holds only the staged rows
        host_traffic = 2.0 * n * row_bytes / _env("HOST_LINK_BANDWIDTH")
        host_mem = 3.0 * n * row_bytes / 5.0e10
        out.append(_Option(
            HOST_OFFLOAD,
            host_traffic + host_mem + _env("HOST_LINK_LATENCY"),
            mem_bytes=2.0 * n * row_bytes,
            ddr_bytes=bytes_table,
        ))
    return out


def create_plan(
    specs: Sequence[TableSpec],
    n_devices: int,
    batch_size: int,
    avg_ids_per_sample: float = 1.0,
    optimizer_kind: str = "adagrad",
    hbm_budget: Optional[float] = None,
    ddr_budget: Optional[float] = None,
    n_bins: int = 64,
    n_ddr_bins: int = 16,
    shards_per_host: int = 1,
    host_excluded: Optional[Set[str]] = None,
    _return_cost: bool = False,
) -> Dict[str, str]:
    """2-D DP over (HBM, DDR) memory bins -> {table_name: sharding}.

    host_excluded: table names that must not offload (zch/dynamicemb
    tables remap ids on-device).
    With ``_return_cost`` returns (plan, est_seconds_per_step,
    {table: est_seconds}) — the cost-model estimate the log line
    prints, exposed so tests can pin non-trivial estimates
    (plan_cost() is the public wrapper).
    """
    if not specs:
        # a model without tables (the SID models' raw vectors)
        return ({}, 0.0, {}) if _return_cost else {}
    reserve = _env("STORAGE_RESERVE_PERCENT")
    budget = (
        hbm_budget if hbm_budget is not None else _env("HBM_CAPACITY")
    ) * (1.0 - reserve)
    ddr = (
        ddr_budget if ddr_budget is not None else _ddr_capacity()
    ) * (1.0 - reserve)
    opt_factor = _OPT_STATE_FACTOR.get(optimizer_kind, 1.0)
    host_ok = (
        optimizer_kind in _HOST_OPT_KINDS
        and int(os.environ.get("TZREC_DISABLE_HOST_OFFLOAD", "0")) == 0
    )
    # host_offload is single-process only in the JAX package too
    host_ok = host_ok and _process_count() == 1
    # a zero/negative DDR budget means NO host tier (the inf bin size
    # below would otherwise admit host options at zero bin cost)
    host_ok = host_ok and ddr > 0
    host_excluded = host_excluded or set()
    ids = batch_size * avg_ids_per_sample

    table_opts: List[List[_Option]] = []
    for s in specs:
        opts = _options(
            s, n_devices, ids, opt_factor, shards_per_host,
            allow_host=host_ok and s.name not in host_excluded,
        )
        if s.sharding_types:
            allowed = set()
            for st in s.sharding_types:
                if st in COMPAT_SHARDING:
                    logger.warning(
                        f"planner: table {s.name}: sharding type "
                        f"{st!r} has no TPU-native layout; using "
                        f"{COMPAT_SHARDING[st]!r} (docs/sharding.md)"
                    )
                    allowed.add(COMPAT_SHARDING[st])
                else:
                    allowed.add(st)
            unknown = allowed - ALL_SHARDINGS
            if unknown:
                raise PlanError(
                    f"table {s.name}: unknown sharding_types "
                    f"{sorted(unknown)}; known: {sorted(ALL_SHARDINGS)}"
                )
            narrowed = [o for o in opts if o.sharding in allowed]
            if not narrowed:
                raise PlanError(
                    f"table {s.name}: constraints "
                    f"{list(s.sharding_types)} match no feasible layout "
                    f"at n_devices={n_devices} (dim={s.dim} "
                    f"shards_per_host={shards_per_host}); relax the "
                    "embedding_constraints or change the mesh"
                )
            opts = narrowed
        table_opts.append(opts)

    bin_bytes = budget / n_bins
    ddr_bin_bytes = ddr / n_ddr_bins if ddr > 0 else float("inf")
    inf = float("inf")
    # dp[(hb, db)] = (cost, choices) best plan using <= hb HBM bins and
    # <= db DDR bins
    dp = {(0, 0): (0.0, [])}
    for opts in table_opts:
        ndp: Dict[tuple, tuple] = {}
        for (hb, db), (cost, choices) in dp.items():
            for oi, o in enumerate(opts):
                need_h = int(-(-o.mem_bytes // bin_bytes))
                need_d = (
                    int(-(-o.ddr_bytes // ddr_bin_bytes))
                    if o.ddr_bytes else 0
                )
                nh, nd = hb + need_h, db + need_d
                if nh > n_bins or nd > n_ddr_bins:
                    continue
                ncost = cost + o.time_cost
                cur = ndp.get((nh, nd))
                if cur is None or ncost < cur[0]:
                    ndp[(nh, nd)] = (ncost, choices + [oi])
        dp = ndp
        if not dp:
            break
    best = min(dp.values(), key=lambda e: e[0]) if dp else (inf, None)
    if best[1] is None:
        # infeasible budgets must fail loudly (reference: TorchRec's
        # planner raises PlannerError) — a silently-degraded plan OOMs
        # later with a far worse message
        total = sum(
            s.rows * s.dim * 4.0 * (1.0 + opt_factor) for s in specs
        )
        raise PlanError(
            f"no sharding plan fits: {len(specs)} tables need "
            f"{total / 1e9:.1f} GB (+opt state) against "
            f"{budget * n_devices / 1e9:.1f} GB HBM across "
            f"{n_devices} devices and {ddr / 1e9:.1f} GB host DDR "
            f"(reserve={reserve:.0%}). Raise HBM_CAPACITY/DDR_CAPACITY, "
            "add devices, or relax per-table embedding_constraints"
        )
    plan = {
        s.name: table_opts[i][oi].sharding
        for i, (s, oi) in enumerate(zip(specs, best[1]))
    }
    counts: Dict[str, int] = {}
    for v in plan.values():
        counts[v] = counts.get(v, 0) + 1
    per_table = {
        s.name: table_opts[i][oi].time_cost
        for i, (s, oi) in enumerate(zip(specs, best[1]))
    }
    logger.info(
        "planner: "
        + ", ".join(f"{c} {k}" for k, c in sorted(counts.items()))
        + f" tables (est {best[0] * 1e3:.3f} ms/step comm+mem)"
    )
    if _return_cost:
        return plan, best[0], per_table
    return plan


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def plan_cost(specs: Sequence[TableSpec], **kw):
    """(plan, est_seconds_per_step, {table: est_seconds}) — same
    arguments as create_plan."""
    return create_plan(specs, _return_cost=True, **kw)


def save_plan(plan: Dict[str, str], model_dir: str) -> None:
    """Write ``sharding_plan.json`` whole: written under a name of the
    process's own and renamed into place, so that another rank's
    ``load_plan`` never reads it half written (rank 0 rewrites the plan
    it loaded when a run continues)."""
    path = os.path.join(model_dir, "sharding_plan.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(plan, f, indent=2)
    os.replace(tmp, path)


def load_plan(model_dir: str) -> Optional[Dict[str, str]]:
    path = os.path.join(model_dir, "sharding_plan.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None
