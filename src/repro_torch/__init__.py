"""ALock lock-table simulator on PyTorch + CUDA (NVIDIA Hopper).

The closed-loop main path: ``Workload`` specs -> ``lower()`` ->
``WorkloadOperands`` -> counter-based draw stream -> next-event loop over
B replicas x n_events -> ``SimResult`` / ``BatchResult``. The event loop
is a hand-written CUDA kernel (``csrc/event_loop.cu``); its plain PyTorch
version lives beside the wrapper and runs wherever a tensor lies on the
CPU.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
CUDA device that default raises instead of carrying on on the CPU.
"""
