"""A Run = one solver execution directory (port of python/rootba/run.py
concepts: status classification from status.log / output.log, log
loading)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from rootba_tpu_torch.eval.log import Attrs, find_log, load_ba_log


@dataclass
class Run:
    dirpath: str
    name: str = ""
    status: str = "unknown"  # completed | failed | oom | timeout | unknown
    log: Optional[Attrs] = None

    @staticmethod
    def load(dirpath: str) -> "Run":
        run = Run(dirpath=dirpath, name=os.path.basename(dirpath.rstrip("/")))
        status_path = os.path.join(dirpath, "status.log")
        if os.path.exists(status_path):
            content = open(status_path).read().strip().lower()
            if "completed" in content:
                run.status = "completed"
            elif "oom" in content or "out of memory" in content:
                run.status = "oom"
            elif "timeout" in content or "time limit" in content:
                run.status = "timeout"
            else:
                run.status = "failed"
        output_path = os.path.join(dirpath, "output.log")
        if run.status in ("unknown", "failed") and os.path.exists(output_path):
            tail = open(output_path, errors="replace").read()[-4096:].lower()
            if "out of memory" in tail or "oom" in tail:
                run.status = "oom"
        try:
            run.log = load_ba_log(find_log(dirpath))
            if run.status == "unknown":
                run.status = "completed"
        except (FileNotFoundError, ValueError):
            if run.status == "unknown":
                run.status = "failed"
        return run

    @property
    def is_failed(self) -> bool:
        return self.status != "completed"
