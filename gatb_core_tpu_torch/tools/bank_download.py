"""BankDownload equivalent (tools/BankDownload.cpp): fetch a bank from a
URL (-url), gunzip if needed, iterate it for statistics, and attach the
stats as filesystem extended attributes when the filesystem supports
them (the reference uses inode xattrs readable with `getfattr -d`).
Port of gatb_core_tpu/tools/bank_download.py (host code, the same urllib
calls).

Usage: python -m gatb_core_tpu_torch.tools.bank_download -url <URL> [-out DIR]
Works with file://, http(s):// and ftp:// URLs (network permitting).
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import sys
import urllib.request


def download(url: str, out_dir: str = ".") -> str:
    name = url.rstrip("/").rsplit("/", 1)[-1] or "bank"
    dest = os.path.join(out_dir, name)
    try:
        # stream into a temp then rename: safe when the URL is a
        # file:// path pointing at the destination itself
        with urllib.request.urlopen(url, timeout=60) as r, \
                open(dest + ".part", "wb") as f:
            shutil.copyfileobj(r, f)
        os.replace(dest + ".part", dest)
    except (OSError, ValueError) as exc:   # ValueError: malformed URL
        try:
            os.unlink(dest + ".part")
        except OSError:
            pass
        # a catchable exception for library callers; main() maps it to
        # the CLI's exit
        raise RuntimeError(f"download failed for {url}: {exc}") from exc
    if dest.endswith(".gz"):        # reference gunzips downloaded banks
        plain = dest[:-3]
        with gzip.open(dest, "rb") as fin, open(plain, "wb") as fout:
            shutil.copyfileobj(fin, fout)
        os.unlink(dest)
        dest = plain
    return dest


def annotate(path: str) -> dict:
    """Iterate the bank for stats; best-effort xattr annotation
    (BankDownload.cpp's getfattr-visible metadata)."""
    from ..bank.fasta import open_bank

    n = total = mx = 0
    for seq in open_bank(path):
        n += 1
        total += len(seq)
        mx = max(mx, len(seq))
    stats = {"sequences": n, "total_nt": total, "max_len": mx}
    setx = getattr(os, "setxattr", None)   # Linux-only API
    for key, val in stats.items():
        if setx is None:
            break
        try:
            setx(path, f"user.gatb.{key}", str(val).encode())
        except OSError:
            break                   # filesystem without xattr support
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="BankDownload")
    p.add_argument("-url", dest="url", required=True)
    p.add_argument("-out", dest="out", default=".")
    args = p.parse_args(argv)
    try:
        dest = download(args.url, args.out)
    except RuntimeError as exc:
        raise SystemExit(str(exc))
    stats = annotate(dest)
    print(f"{dest}: {stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
