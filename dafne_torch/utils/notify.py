"""Run reports: ``run_report.json`` and the notification hooks.

Counterpart of ``dafne_tpu/utils/notify.py``.  At the end of a CLI run
(``tools/train.py``: ``eval_done``, ``train_done`` or ``failed``) the report
``{"status", "experiment", "output_dir", "results"[, "error"]}`` is written
to OUTPUT_DIR/run_report.json; the shell command in DAFNE_NOTIFY_CMD, when
set, gets it as JSON on stdin (mail, a chat webhook, a pager: anything);
and when EMAIL_CREDENTIALS names a JSON file (``user``, ``password``, and
optionally ``to``, ``host``, ``port``) it is mailed over SMTP with SSL.  A
failing hook never fails the run.
"""

from __future__ import annotations

import json
import os
import subprocess
import traceback
from typing import Dict, Optional


def build_report(status: str, cfg=None, results: Optional[Dict] = None, error: str = "") -> Dict:
    report = {
        "status": status,
        "experiment": getattr(cfg, "EXPERIMENT_NAME", "") if cfg else "",
        "output_dir": getattr(cfg, "OUTPUT_DIR", "") if cfg else "",
        "results": results or {},
    }
    if error:
        report["error"] = error
    return report


def notify(status: str, cfg=None, results=None, error: str = "") -> Dict:
    """Write OUTPUT_DIR/run_report.json and call the hooks; returns the report."""
    report = build_report(status, cfg, results, error)
    out_dir = report.get("output_dir") or "."
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "run_report.json"), "w") as f:
            json.dump(report, f, indent=2, default=float)
    except OSError:
        pass
    cmd = os.environ.get("DAFNE_NOTIFY_CMD", "")
    if cmd:
        try:
            subprocess.run(cmd, shell=True, input=json.dumps(report, default=float).encode(), timeout=60)
        except Exception:
            traceback.print_exc()
    creds = os.environ.get("EMAIL_CREDENTIALS", "")
    if creds and os.path.exists(creds):
        _send_email(creds, report)
    return report


def _send_email(creds_path: str, report: Dict) -> None:
    """Mail the report over SMTP with SSL, with the credentials file's
    ``user``, ``password``, ``to`` (default ``user``), ``host`` (default
    smtp.gmail.com) and ``port`` (default 465)."""
    try:
        import smtplib
        from email.mime.text import MIMEText

        with open(creds_path) as f:
            creds = json.load(f)
        msg = MIMEText(json.dumps(report, indent=2))
        msg["Subject"] = f"[dafne_torch] {report['status']}: {report.get('experiment', '')}"
        msg["From"] = creds["user"]
        msg["To"] = creds.get("to", creds["user"])
        with smtplib.SMTP_SSL(creds.get("host", "smtp.gmail.com"), creds.get("port", 465)) as s:
            s.login(creds["user"], creds["password"])
            s.send_message(msg)
    except Exception:
        traceback.print_exc()
