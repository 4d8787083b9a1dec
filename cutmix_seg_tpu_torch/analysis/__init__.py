"""The paper's input-space studies (port of cutmix_seg_tpu.analysis)."""
