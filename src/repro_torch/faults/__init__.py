"""Fault injection (the port's copy of ``repro.faults``): the counter-PRNG
fault model and the lossy-link transmit simulation with checksummed
retries."""
from repro_torch.faults.model import (FaultConfig, FaultModel, LevelFaults,
                                      LevelPlan, LinkFaults, RoundFaultPlan,
                                      counter_normal, counter_uniform)
from repro_torch.faults.transmit import (RETRY_TAG, TransmitResult,
                                         corrupt_payload,
                                         expected_transmissions, transmit)

__all__ = [
    "FaultConfig", "FaultModel", "LevelFaults", "LevelPlan", "LinkFaults",
    "RoundFaultPlan", "counter_normal", "counter_uniform", "RETRY_TAG",
    "TransmitResult", "corrupt_payload", "expected_transmissions", "transmit",
]
