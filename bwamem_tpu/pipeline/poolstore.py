"""Learned seed-pool size persistence.

The device seeding program reports a need/cap multiplier PER POOL
(ops/seeding.py smem_seed_batch "mults"); an overflow retry resizes only
the overflowing pools, and the converged configuration is persisted here
so later PROCESSES (the CLI is one-shot; the bench is a fresh process)
start right-sized — no overflow retries, no retry recompiles. The
equivalent of GASAL2's pre-sized device pools (reference:
src/fastmap.c:495-507 gasal_init_streams with fixed max_batch sizes),
except learned instead of hard-coded.

Entries only grow (per-field max-merge), so a repeat-rich input can
never shrink the pools a worse input needed. Writes are atomic
(temp + rename) and best-effort: a read-only cache dir degrades to
in-process learning only.
"""
from __future__ import annotations

import json
import os
import threading

# SeedConfig pool fields, in the order of the device "mults" vector
# (r2_emit retired in round 3: the round-2 emission plane is trip-indexed
# and always fits, so that knob and its overflow-retry class are gone;
# stale sidecar entries carrying it are ignored by lookup())
POOL_FIELDS = ("cand_pool", "r2_pool", "r2_cand", "r3_pool",
               "merge_pool", "seed_pool")
# per-stage caps: beyond these the spill path (batch split) takes over
POOL_CAPS = {"cand_pool": 4096, "r2_pool": 1024,
             "r2_cand": 2048, "r3_pool": 1024, "merge_pool": 8192,
             "seed_pool": 4096}


def default_path() -> str:
    from .. import CHECKOUT

    return os.environ.get("BWAMEM_TPU_POOLS",
                          os.path.join(CHECKOUT, ".pools.json"))


def _quant(x: float) -> int:
    """Quantize a pool size up: exact integers through 8 (tiny pools
    multiply whole device passes — pow2 rounding 3->4 costs a third of a
    backward/forward stage), multiples of 8 above (bounds executable
    variety; hwm is max-merged so sizes stabilize quickly)."""
    import math

    x = max(int(math.ceil(x)), 1)
    return x if x <= 8 else -(-x // 8) * 8


# start size = high-water per-read need x this margin (one overflow
# retry self-corrects an underestimate and raises the stored hwm).
# 1.2: the hwm is already a MAX over every chunk seen for the class,
# and pool width is paid every chunk in backward-walk lanes (the
# round-2 walk over B*r2_cand lanes is the largest seeding stage)
_HWM_MARGIN = 1.2


class PoolStore:
    def __init__(self, path: str | None = None):
        self.path = path or default_path()
        self._lock = threading.Lock()
        self._data: dict[str, dict] = {}
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if isinstance(raw, dict):
                for k, v in raw.items():
                    if not isinstance(v, dict):
                        continue
                    ent = {f_: int(v[f_]) for f_ in POOL_FIELDS if f_ in v}
                    hwm = v.get("_hwm")
                    if isinstance(hwm, dict):
                        ent["_hwm"] = {f_: float(hwm[f_])
                                       for f_ in POOL_FIELDS if f_ in hwm}
                    self._data[k] = ent
        except (OSError, ValueError):
            pass

    @staticmethod
    def key(mode: str, reseed: bool, min_seed_len: int, L: int,
            gid: int | None = None) -> str:
        """gid: genome identity (l_pac) — pool pressure is a property of
        the (genome, read profile) pair; without it a one-off repeat-rich
        run permanently over-provisions every later workload."""
        base = f"{mode}:rs{int(bool(reseed))}:msl{min_seed_len}:L{L}"
        return base if gid is None else f"{base}:g{int(gid)}"

    def lookup(self, key: str) -> dict[str, int] | None:
        """Starting pool sizes for this class: the high-water per-read
        need x margin when recorded (lets pools START SMALLER than a
        converged worst-case cap — oversized pools cost backward/SA-walk
        lanes and argsort width every chunk), else the converged cap."""
        with self._lock:
            v = self._data.get(key)
            if not v:
                return None
            hwm = v.get("_hwm", {})
            out = {}
            for f_ in POOL_FIELDS:
                if f_ in hwm:
                    cap = v.get(f_)
                    sz = _quant(hwm[f_] * _HWM_MARGIN)
                    out[f_] = min(sz, cap) if cap else sz
                elif f_ in v:
                    out[f_] = v[f_]
            return out or None

    def update(self, key: str, fields: dict[str, int],
               hwm: dict[str, float] | None = None) -> None:
        """Max-merge converged caps (and per-read need high-water marks)
        into the entry; persist if anything grew."""
        with self._lock:
            cur = self._data.setdefault(key, {})
            changed = False
            for f_, v in fields.items():
                if f_ in POOL_FIELDS and int(v) > cur.get(f_, 0):
                    cur[f_] = int(v)
                    changed = True
            if hwm:
                ch = cur.setdefault("_hwm", {})
                for f_, v in hwm.items():
                    if f_ in POOL_FIELDS and float(v) > ch.get(f_, 0.0):
                        ch[f_] = float(v)
                        changed = True
            if not changed:
                return
            try:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                tmp = f"{self.path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(self._data, f, indent=0, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                pass  # best-effort: keep the in-process copy


_default: PoolStore | None = None
_default_lock = threading.Lock()


def get_store() -> PoolStore:
    """Process-wide store for the default path (env-sensitive: a changed
    BWAMEM_TPU_POOLS gets a fresh store — tests point it at tmp dirs)."""
    global _default
    with _default_lock:
        if _default is None or _default.path != default_path():
            _default = PoolStore()
        return _default
