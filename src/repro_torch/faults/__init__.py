"""Fault injection (the port's copy of ``repro.faults.model``)."""
from repro_torch.faults.model import (FaultConfig, FaultModel, LevelFaults,
                                      LevelPlan, LinkFaults, RoundFaultPlan,
                                      counter_normal, counter_uniform)
