from repro_torch.runtime.fault import FaultInjector, SimulatedFault, run_with_restarts

__all__ = ["FaultInjector", "SimulatedFault", "run_with_restarts"]
