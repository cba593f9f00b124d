"""ceph-lint over the port: one static-analysis engine for
``ceph_tpu_torch/``.

The port's copy of ``ceph_tpu.analysis`` (reference analog: the checks
Ceph ships as ``src/common/lockdep.cc`` + the mutex-debug layer, done
ahead of time instead of at runtime):

- :mod:`.engine`   — the project index (AST for every file + a
  cross-module symbol/call index) and the declarative rule registry;
- :mod:`.lockmodel` — the shared lock/acquisition walker (who holds
  what, where) both deep analyses build on;
- :mod:`.rules_locks`   — lock-order deadlock detection + callbacks/
  sends invoked under a held lock;
- :mod:`.rules_threads` — thread-context classification + cross-thread
  unlocked-mutation detection;
- :mod:`.rules_torch`   — launch purity (host syncs reachable from a
  hand-kernel launch), in the place of the JAX package's ``rules_jax``;
- :mod:`.rules_guards`  — the guards (host-sync, bounded queues/retries,
  blocking sockets, span owner/phase, profiler confinement, bare clocks,
  counter help, percentile redefinitions, wire-sizer registry);
- :mod:`.rules_observability`, :mod:`.rules_copy` — instrument updates
  under a lock, payload copies on the data path.

Entry point: ``python -m ceph_tpu_torch.tools.ceph_lint`` (CLI with
``--baseline``; the default baseline is ``analysis/baseline.json``).
Importing the package loads neither ``torch`` nor anything of the JAX
package; rules that need runtime registries import them lazily inside
their check.
"""
from .engine import (Finding, ProjectIndex, Rule, all_rules,  # noqa: F401
                     default_index, get_rule, load_baseline,
                     run_rule_on_sources, run_rules, split_by_baseline,
                     write_baseline)

# registering the rule modules populates the registry as a side effect
from . import rules_copy  # noqa: F401,E402
from . import rules_guards  # noqa: F401,E402
from . import rules_locks  # noqa: F401,E402
from . import rules_observability  # noqa: F401,E402
from . import rules_threads  # noqa: F401,E402
from . import rules_torch  # noqa: F401,E402
