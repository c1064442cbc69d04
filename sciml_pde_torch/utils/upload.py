"""Dataverse upload (port of ``sciml_pde_tpu/utils/upload.py``): a curl
POST of one file to a Dataverse dataset, with retries.  It runs curl only
when called without ``dry_run``; the command list is returned either way."""

from __future__ import annotations

import json
import logging
import subprocess
from pathlib import Path

log = logging.getLogger(__name__)


def dataverse_upload(
    file_path: str | Path,
    dataverse_url: str,
    dataverse_token: str,
    dataverse_id: str,
    dataverse_dir: str | None = None,
    retry: int = 10,
    dry_run: bool = False,
) -> list[str]:
    meta = {"description": "", "categories": ["Data"], "restrict": "false"}
    if dataverse_dir:
        meta["directoryLabel"] = f"{dataverse_dir}/"
    cmd = [
        "curl", "-X", "POST",
        "-H", f"X-Dataverse-key:{dataverse_token}",
        "-F", f"file=@{file_path}",
        "-F", "jsonData=" + json.dumps(meta),
        f"{dataverse_url}/api/datasets/:persistentId/add?persistentId={dataverse_id}",
        "--retry", str(retry),
    ]
    log.info("upload cmd %s", cmd)
    if not dry_run:
        subprocess.Popen(cmd)
    return cmd
