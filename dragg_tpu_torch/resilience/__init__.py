"""Supervised device execution (the counterpart of
``dragg_tpu/resilience``): device work in a child process with a
deadline, a heartbeat and a classified verdict, and the checkpointed
CUDA→CPU degradation of ``run --supervised``.

* :mod:`supervisor`: run a workload in a CHILD process with a hard
  deadline, a progress-heartbeat file and stdout/stderr capture, so that
  a hang kills the child and not the parent (which never imports torch);
* :mod:`liveness`: the subprocess CUDA probe (:mod:`dragg_tpu_torch.probe`)
  as a classified verdict, with probe-gated exponential backoff;
* :mod:`taxonomy`: the failure vocabulary (``TUNNEL_DOWN``, ``WEDGED``,
  ``COMPILE_HANG``, ``VMEM_OOM``, ``CHILD_CRASH``, ``DEADLINE``), the JAX
  package's names, and the classifiers;
* :mod:`runner`: retry ladders and the degradation policy: on a card
  lost mid-run, resume the same run on the CPU from the latest checkpoint
  and record the transition in the provenance JSON;
* :mod:`faults`: deterministic fault injection (``$DRAGG_FAULT_INJECT``,
  the JAX package's grammar and sites);
* :mod:`heartbeat`: the child-side progress beats;
* :mod:`net`: socket deadline helpers.

Import rule: nothing here imports torch at module level, and the parent
side (supervisor, liveness, runner, taxonomy, faults) never imports it at
all; probes and workloads run in subprocesses (:mod:`simchild`).
``devices`` counts the ranks a run shards over (not imported here: it
reads the process's world).
"""

from dragg_tpu_torch.resilience.taxonomy import (  # noqa: F401
    CHILD_CRASH,
    COMPILE_HANG,
    DEADLINE,
    FAILURE_KINDS,
    TUNNEL_DOWN,
    VMEM_OOM,
    WEDGED,
    classify_child,
    classify_liveness,
)
from dragg_tpu_torch.resilience.liveness import (  # noqa: F401
    LivenessReport,
    backoff_delays,
    check_liveness,
)
from dragg_tpu_torch.resilience.net import (  # noqa: F401
    connect_deadline,
    parse_endpoint,
    recv_exact,
)
from dragg_tpu_torch.resilience.supervisor import (  # noqa: F401
    SupervisedResult,
    assert_parent_has_no_torch,
    run_supervised,
)
