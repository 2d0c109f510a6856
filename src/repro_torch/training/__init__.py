"""Training (port of ``repro.training``): the train steps, the loop and the
checkpoints (``steps``, ``loop``, ``checkpoint``), and the continuous
batcher of the serving path."""
from repro_torch.training.serving import ContinuousBatcher, Request, ServeStats
