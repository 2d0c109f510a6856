"""Training (port of ``repro.training``): the train steps, the loop and the
checkpoints (``steps``, ``loop``, ``checkpoint``), and the continuous
batcher of the serving path."""
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.loop import train
from repro_torch.training.serving import ContinuousBatcher, Request, ServeStats
from repro_torch.training.steps import (TrainState, init_train_state, make_decode_step,
                                        make_prefill_step, make_train_step)
