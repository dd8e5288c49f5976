"""Probe entry points of the port (counterparts of ``scripts/probe_*.py``).

    python -m pixie_tpu_torch.scripts.probe_kernel_ablation
    python -m pixie_tpu_torch.scripts.probe_vmem_gather
"""
