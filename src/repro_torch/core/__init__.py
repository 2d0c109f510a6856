from repro_torch.core.compressors import (Compressor, WireSpec, identity,
                                         make_compressor, qsgd, qsgd_kernel,
                                         scale_compressor, top_k)
