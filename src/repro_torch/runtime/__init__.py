"""Fault-tolerant training runtime: the fault matrix, storage chaos, elastic
re-decomposition and the chunk supervisor (the reference package's
``runtime`` package, over this package's trainer and checkpoints)."""
from repro_torch.runtime.chaos import (ChaosInjector, compose, corrupt_file,
                                       corrupt_generation)
from repro_torch.runtime.elastic import (CentroidSpec, balanced_counts,
                                         remap_params, throughput_weights)
from repro_torch.runtime.failures import (ALL_FAULT_KINDS, FAULT_KINDS,
                                          SERVE_FAULT_KINDS,
                                          STORAGE_FAULT_KINDS, Fault,
                                          FaultInjector, FaultyEngine,
                                          InjectedFailure, inject_nan,
                                          parse_faults, run_with_failures)
from repro_torch.runtime.supervisor import (Supervisor, SupervisorConfig,
                                            SupervisorReport,
                                            decomp_signature, elastic_resume)
