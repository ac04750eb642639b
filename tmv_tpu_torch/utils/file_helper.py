"""Regex-filtered recursive file listing and directory listing.

The port's own copy of ``tmv_tpu/utils/file_helper.py`` (the reference's
``ReadFileList`` and ``ReadDirList``, `utils/file_helper.py:4-67`).
"""

import os
import re
from typing import List, Optional


def read_file_list(dir_path: str, pattern: Optional[str] = None,
                   recursive: bool = True) -> List[str]:
    """All file paths under ``dir_path`` whose name matches ``pattern``."""
    matcher = re.compile(pattern) if pattern else None
    out: List[str] = []
    if recursive:
        for root, _dirs, files in os.walk(dir_path):
            for f in sorted(files):
                if matcher is None or matcher.search(f):
                    out.append(os.path.join(root, f))
    else:
        for f in sorted(os.listdir(dir_path)):
            p = os.path.join(dir_path, f)
            if os.path.isfile(p) and (matcher is None or matcher.search(f)):
                out.append(p)
    return out


def read_dir_list(dir_path: str, pattern: Optional[str] = None) -> List[str]:
    """The subdirectories of ``dir_path`` (not recursive), sorted, whose name
    matches ``pattern``."""
    matcher = re.compile(pattern) if pattern else None
    return [
        os.path.join(dir_path, d)
        for d in sorted(os.listdir(dir_path))
        if os.path.isdir(os.path.join(dir_path, d))
        and (matcher is None or matcher.search(d))
    ]
