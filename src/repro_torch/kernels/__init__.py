"""Hand-written Hopper kernels of the port, their plain versions and their
launch counts (``LAUNCHES``)."""
from .build import LAUNCHES
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_ref, flash_attention_ref)
from .rmsnorm import rmsnorm, rmsnorm_bwd, rmsnorm_bwd_ref, rmsnorm_ref
from .slstm_scan import (slstm_scan, slstm_scan_bwd, slstm_scan_bwd_ref,
                         slstm_scan_ref)
from .ssd_scan import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_ref

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_ref", "rmsnorm",
           "rmsnorm_bwd", "rmsnorm_bwd_ref", "rmsnorm_ref", "slstm_scan",
           "slstm_scan_bwd", "slstm_scan_bwd_ref", "slstm_scan_ref",
           "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_ref", "ssd_scan_ref"]
