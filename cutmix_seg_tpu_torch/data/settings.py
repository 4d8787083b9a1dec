"""Dataset-path configuration: INI file `semantic_segmentation.cfg`.

Same contract as the reference (reference: settings.py:16-49): a `[paths]`
section maps config names (pascal_voc, cityscapes, camvid, isic2017, toy2d) to
directories/files. The file is searched in the current directory, then
$CUTMIX_SEG_CONFIG if set.
"""

from __future__ import annotations

import os
from configparser import RawConfigParser

_CONFIG_PATH = "./semantic_segmentation.cfg"
_config = None


def get_config() -> RawConfigParser:
    global _config
    if _config is None:
        _config = RawConfigParser()
        path = os.environ.get("CUTMIX_SEG_CONFIG", _CONFIG_PATH)
        if os.path.exists(path):
            _config.read(path)
    return _config


def get_data_path(config_name: str, exists: bool = True,
                  dnnlib_template: str | None = None) -> str:
    """Resolve a dataset path. When the optional ``dnnlib`` package is
    importable and a template is given, the reference resolves the path from
    the template instead of the INI file (reference: settings.py:45-49);
    mirrored here so configs written for that flow carry over."""
    if dnnlib_template is not None:
        try:
            import dnnlib

            path = dnnlib.submission.submit.get_path_from_template(
                dnnlib_template)
        except (ImportError, AttributeError):
            # absent OR an unrelated package named dnnlib -> INI fallback;
            # a real dnnlib raising on a bad template must propagate, not
            # silently train on the INI path instead
            path = None
        if path is not None:
            if exists and not os.path.exists(path):
                raise RuntimeError(
                    f"dnnlib template for {config_name!r} resolved to a "
                    f"non-existent path: {path}")
            return path
    cfg = get_config()
    if not cfg.has_option("paths", config_name):
        raise RuntimeError(
            f"no path configured for {config_name!r}; add it to the [paths] "
            f"section of semantic_segmentation.cfg"
        )
    path = cfg.get("paths", config_name)
    if exists and not os.path.exists(path):
        raise RuntimeError(f"configured path for {config_name!r} does not exist: {path}")
    return path
