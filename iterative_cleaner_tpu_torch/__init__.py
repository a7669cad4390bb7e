"""iterative_cleaner_tpu_torch — the iterative "surgical" RFI cleaner in
PyTorch, for an NVIDIA H100.

A port of ``iterative_cleaner_tpu`` (JAX on a TPU), which stays beside it as
the reference: same inputs in, identical flag masks out.  It imports torch,
numpy and the standard library, never JAX or the JAX package.  Its entry
points run on the card unless the caller passes ``device="cpu"``.

Layer map (module names mirror the JAX package's):

  service             .service.*                        (serve: HTTP jobs, sessions)
  CLI / driver        .cli, .driver                     (host)
  online              .online.follow, .session, .state  (--follow: growing archives)
  model               .models.surgical                  (archive in/out)
                      .models.sweep                     (--sweep: threshold grids)
  core loop           .core.cleaner                     (backend-agnostic)
  backends            .backends.numpy_backend (oracle)  (executable spec)
                      .backends.torch_backend           (device, stepwise)
  parallel            .parallel.chunked, .autoshard     (cubes beyond the card)
                      .parallel.batch, .sharded, .mesh  (directory batch, meshes)
  ops                 .ops.template, .masked, .stats    (torch ops; the template
                                                         kernel csrc/ordered_template.cu)
                      .ops.fused_kernels + csrc/*.cu    (hand-written CUDA)
                      .ops.preprocess, .native          (host: numpy, or C++/OpenMP)
  io                  .io.*                             (NPZ, .ictb; .io.tail polls a
                                                         growing file)
  observability       .obs.* , .utils.device_probe      (events, metrics, forensics,
                                                         audit, torch.profiler, memory,
                                                         costs)
  wire                .ingest.codec, .online.blocks     (the session block codec)
  state transfer      .convert                          (from the JAX package)
"""

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.io.base import Archive

__version__ = "0.1.0"

__all__ = ["CleanConfig", "Archive", "__version__"]
