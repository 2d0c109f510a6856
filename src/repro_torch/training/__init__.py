from repro_torch.training.serving import ContinuousBatcher, Request, ServeStats
