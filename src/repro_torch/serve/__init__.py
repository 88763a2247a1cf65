"""Field-serving subsystem: export -> route -> stitch -> serve.

Counterpart of the reference package's ``serve`` package: freeze a trained
cPINN/XPINN into a self-contained artifact (:mod:`repro_torch.serve.export`,
the same on-disk format), route query clouds to subdomains
(:mod:`repro_torch.serve.routing`), evaluate every subdomain in one batched
network call per field and stitch a single-valued field across interfaces
(:mod:`repro_torch.serve.engine`), front the engine with microbatching + an
LRU result cache (:mod:`repro_torch.serve.frontend`), and keep the stack
serving under production traffic — admission control, deadlines, degraded
modes, circuit breaking (:mod:`repro_torch.serve.resilience`).
"""
from repro_torch.serve.export import (CorruptBundleError, FieldBundle,
                                      export_bundle, load_bundle)
from repro_torch.serve.engine import FieldEngine
from repro_torch.serve.frontend import ServeFrontend, UnknownTicketError
from repro_torch.serve.resilience import (CircuitBreaker, EngineOutputError,
                                          GuardedEngine, ResilienceConfig,
                                          ResilientFrontend, ServeResult)
from repro_torch.serve.routing import membership_matrix, route, RoutedQuery
