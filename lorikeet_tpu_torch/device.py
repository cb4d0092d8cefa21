"""Device probe: what CUDA card (if any) this process can use.

``probe()`` reports what a run needs to state beside its numbers: torch and
CUDA versions, the card's name and compute capability (an H100 reports
(9, 0)), its name and power limit as ``nvidia-smi`` prints them, and the
``nvcc`` that builds the kernels.  ``require_cuda()`` is the single gate the
device paths use: no card means an error, never a silent host fallback.
"""
from __future__ import annotations

import shutil
import subprocess

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when this process has no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}).  This path runs on the card; only an "
            "explicit --force-cpu / use_cuda=False selects the host")
    return torch.device("cuda")


def device_list(devices) -> list:
    """``devices`` (a device, or a list of them) as a list of torch
    devices: an error when one is a card and this process has none."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in devices):
        require_cuda()
    return devices


def nvidia_smi_line() -> str | None:
    """``name, power.limit`` of every visible card, one line each."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    res = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return res.stdout.strip() if res.returncode == 0 else None


def probe() -> dict:
    from lorikeet_tpu_torch.ops._build import find_nvcc, nvcc_version
    info = {"torch": torch.__version__, "torch_cuda": torch.version.cuda,
            "cuda_available": torch.cuda.is_available()}
    if info["cuda_available"]:
        info["name"] = torch.cuda.get_device_name(0)
        info["capability"] = list(torch.cuda.get_device_capability(0))
        info["count"] = torch.cuda.device_count()
    info["nvidia_smi"] = nvidia_smi_line()
    nvcc = find_nvcc()
    info["nvcc"] = nvcc
    info["nvcc_version"] = nvcc_version(nvcc) if nvcc else None
    return info
