"""PyTorch/CUDA port of the ITA heterogeneous deployment flow.

Module for module it mirrors the JAX package beside it: the integer
primitives (``quant``, ``core``), the model-level encoder (``models``),
the deployment flow ``compile(cfg) -> DeploymentPlan -> InferenceSession``
(``deploy``), the request-level serving engine and its HTTP frontend
(``deploy.engine``, ``deploy.serving``) and the serving entry point
(``launch.serve``).  The
accelerator slot of the dispatch table holds CUDA kernels written for
Hopper (``csrc/``, built on first use by ``kernels._build``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead, which is how the tests hold the port against the
JAX package on a host with no GPU.
"""
