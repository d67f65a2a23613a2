from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.grad_compress import CompressorState, compress_init, compressed_psum
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "cosine_schedule",
           "CompressorState", "compress_init", "compressed_psum"]
