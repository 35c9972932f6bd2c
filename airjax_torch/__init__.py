"""airjax_torch — the airjax decode paths in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a): the DF17 main path and the extended
decode of every Mode S downlink format.

A second package beside `airjax` (the JAX reference, which is unchanged).
Every public function here names its airjax counterpart by file and line
and returns the same output, bit for bit, on the same int16 IQ:

  airjax.dsp.magnitude              -> airjax_torch.dsp.magnitude
  airjax.dsp.demod                  -> airjax_torch.dsp.demod
  airjax.kernels.magdet (Pallas)    -> airjax_torch.kernels.magdet + csrc/front.cu
                                       (decode paths), csrc/magdet.cu (oracle)
  (XLA-fused compact_detections)    -> airjax_torch.kernels.compact + csrc/compact.cu
  airjax.kernels.stencil3 (Pallas)  -> airjax_torch.kernels.stencil3 + csrc/magdet.cu
  airjax.protocol.crc               -> airjax_torch.protocol.crc
  (XLA-fused slice + CRC)           -> airjax_torch.kernels.candidate + csrc/candidate.cu
  airjax.protocol.shortframe        -> airjax_torch.protocol.shortframe (CRC, makers)
  airjax.protocol.packet / acas /
    commb, fields (constants)       -> airjax_torch.protocol.*
  airjax.track.icao_cache           -> airjax_torch.track.icao_cache
  airjax.extended (per packet)      -> airjax_torch.extended
  airjax.pipeline                   -> airjax_torch.pipeline
  airjax.runner (per-packet sinks)  -> airjax_torch.runner
  airjax.config                     -> airjax_torch.config
  airjax.io.synth / source / c16    -> airjax_torch.io.synth / source / c16
  airjax.ui.stream                  -> airjax_torch.ui.stream
  airjax.cli (adsb)                 -> airjax_torch.cli
  airjax.parallel (mesh, halo,
    channels, multihost)            -> airjax_torch.parallel.* (+ csrc/shard_gather.cu;
                                       multihost over torch.distributed)
  airjax.golden / visualise         -> airjax_torch.golden / visualise
  airjax.observability              -> airjax_torch.observability (torch.profiler)
  tools/ (fuzzers, soak, replay,
    SNR sweep, multichip dry run)   -> airjax_torch/tools/

Every public name of every airjax module has its counterpart in the port
module of the same path, less a few TPU-only names
(tests/test_torch_names.py).

Device rule (airjax_torch._dispatch): a kernel wrapper given CPU tensors
runs the kernel's plain torch version; given CUDA tensors it launches the
kernel or raises. There is no fallback between the two.

The package imports torch and numpy, never jax and no module of airjax.
"""

from airjax_torch.config import PipelineConfig

__version__ = "0.1.0"

__all__ = ["PipelineConfig", "__version__"]
