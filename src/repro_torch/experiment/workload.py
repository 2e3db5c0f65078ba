"""Shared arch-mix workload construction — one sizing rule, two backends.

The cross-backend guarantee ("same spec, same failover choices") only
holds if both engines hand the planner identical inputs. This module is
the single source of truth for the `app_mix="arch"` workload: the
variant ladders (reduced smoke configs of real architectures), the app
list (ids, rates, criticality drawn from one seeded stream), and the
capacity sizing rule (servers scaled so primaries fill ~50% of the
cluster at the requested headroom, as on the paper's testbed). The
testbed serves these apps with real JAX engines; the simulator places
the exact same objects on a cluster with the exact same capacities.

Imports of the model-config stack are kept inside functions so that
plain synthetic-mix simulation runs never pay the JAX import.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

from repro_torch.core.variants import Application, Variant

# the real architectures the thread testbed can serve (reduced configs)
TESTBED_ARCHS = ["qwen2.5-3b", "qwen3-32b", "recurrentgemma-2b",
                 "rwkv6-3b", "qwen3-moe-30b-a3b"]

# uniform compute budget per serving cell (both backends)
ARCH_COMPUTE_CAP = 1e9


def testbed_ladder(arch: str) -> List[Variant]:
    """Variant ladder over an extra-reduced smoke config (CPU-budget:
    load time is dominated by XLA compiles, the testbed's stand-in for
    the paper's disk-bandwidth-dominated Triton loads)."""
    from repro_torch import configs
    from repro_torch.core.variants import build_ladder

    smoke = configs.get_smoke(arch)
    plen = len(smoke.block_pattern)
    n_layers = plen if not smoke.is_encoder_decoder else 2
    kw = dict(scan_layers=True, num_layers=n_layers)
    if smoke.is_encoder_decoder:
        kw.update(num_encoder_layers=1, num_decoder_layers=1)
    return build_ladder(smoke.replace(**kw), cell_mem=64e6)


def build_arch_apps(archs: Optional[Sequence[str]] = None, *,
                    apps_per_arch: int = 1, critical_frac: float = 0.5,
                    seed: int = 0) -> List[Application]:
    """The arch-mix application set; identical on every backend for the
    same (archs, apps_per_arch, critical_frac, seed)."""
    rng = random.Random(seed)
    apps: List[Application] = []
    i = 0
    for arch in (archs or TESTBED_ARCHS):
        for _ in range(apps_per_arch):
            ladder = testbed_ladder(arch)
            apps.append(Application(
                id=f"{arch}-app{i}", family=arch, variants=ladder,
                request_rate=rng.uniform(0.5, 2.0),
                critical=(rng.random() < critical_frac)))
            i += 1
    return apps


def arch_mem_cap(apps: Sequence[Application], n_servers: int,
                 headroom: float) -> float:
    """Per-server memory so primaries fill ~50% of usable capacity at
    the requested headroom (and the largest primary always fits)."""
    total_primary = sum(a.full.demand["mem"] for a in apps)
    max_primary = max(a.full.demand["mem"] for a in apps)
    return max(total_primary / (n_servers * (1.0 - headroom) * 0.5),
               1.5 * max_primary)
