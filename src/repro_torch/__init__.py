"""repro_torch — the PyTorch/CUDA port of ``repro``.

Topology-aware preemptive scheduling for co-located LLM workloads, with the
candidate-sourcing kernels written by hand in CUDA C++ for Hopper.  The
package imports torch and numpy only; ``repro`` (JAX) is the reference it is
tested against.
"""

__version__ = "0.1.0"
