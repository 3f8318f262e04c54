"""Study downloads: plain URLs, OSF archives and Donders webdav mirrors.

Port of ``brainmagick_tpu/studies/download.py``, which the study adapters
call to fetch a dataset on first use. On a machine without network
access each of them raises ``DownloadError`` with what to do instead.
"""

from __future__ import annotations

import logging
import typing as tp
import zipfile
from pathlib import Path

logger = logging.getLogger(__name__)


class DownloadError(RuntimeError):
    pass


def _urlretrieve(url: str, target: Path) -> None:
    from urllib.request import urlretrieve
    try:
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(target.suffix + ".tmp")
        urlretrieve(url, tmp)
        tmp.rename(target)
    except OSError as e:
        raise DownloadError(
            f"Could not download {url} -> {target}: {e}. This environment "
            "has no network egress; fetch the dataset on a connected "
            "machine and point env.studies at it.") from e


def download_file(url: str, target: Path, force: bool = False) -> Path:
    if target.exists() and not force:
        return target
    logger.info("Downloading %s -> %s", url, target)
    _urlretrieve(url, target)
    return target


def extract_zip(archive: Path, dest: Path, done_marker: str = "") -> None:
    marker = dest / (done_marker or f".extracted_{archive.stem}")
    if marker.exists():
        return
    logger.info("Extracting %s -> %s", archive, dest)
    with zipfile.ZipFile(str(archive)) as zf:
        zf.extractall(str(dest))
    marker.write_text("done")


def download_osf(project_id: str, dest: Path,
                 done_marker: str = "") -> None:
    """Download a full OSF project archive (osf.io/<id>) and extract it
    (gwilliams2022's)."""
    dest = Path(dest)
    archive = dest / f"{project_id}.zip"
    if not archive.exists():
        download_file(
            f"https://files.osf.io/v1/resources/{project_id}/providers/"
            "osfstorage/?zip=", archive)
    extract_zip(archive, dest, done_marker or project_id)


DONDERS_WEBDAV = "https://webdav.data.donders.ru.nl"


def _webdav_request(url: str, auth_header: str, method: str = "GET",
                    depth: tp.Optional[str] = None):
    from urllib.request import Request, urlopen
    headers = {"Authorization": auth_header, "User-Agent": "Mozilla"}
    if depth is not None:
        headers["Depth"] = depth
    return urlopen(Request(url, headers=headers, method=method))


def _webdav_list(url: str, auth_header: str
                 ) -> tp.List[tp.Tuple[str, bool]]:
    """PROPFIND Depth:1 -> [(href, is_collection)] of the members of the
    collection at `url` (the collection itself excluded)."""
    import xml.etree.ElementTree as ET
    from urllib.parse import unquote, urlsplit

    with _webdav_request(url, auth_header, method="PROPFIND",
                         depth="1") as resp:
        tree = ET.fromstring(resp.read())
    ns = {"d": "DAV:"}
    own_path = unquote(urlsplit(url).path).rstrip("/")
    entries = []
    for response in tree.findall("d:response", ns):
        href_el = response.find("d:href", ns)
        if href_el is None or not href_el.text:
            continue
        href = unquote(urlsplit(href_el.text).path)
        if href.rstrip("/") == own_path:
            continue
        is_dir = response.find(
            "d:propstat/d:prop/d:resourcetype/d:collection", ns) is not None
        entries.append((href, is_dir))
    return entries


def mirror_webdav(base_url: str, remote_path: str, dest: Path,
                  user: str, password: str) -> int:
    """Recursively mirror a webdav collection into `dest`; returns the
    number of files fetched; index.html* listings are skipped."""
    import base64
    import posixpath
    import shutil

    auth = "Basic " + base64.b64encode(
        f"{user}:{password}".encode()).decode()
    root = "/" + remote_path.strip("/") + "/"
    n_files = 0
    stack = [root]
    while stack:
        folder = stack.pop()
        for href, is_dir in _webdav_list(base_url + folder, auth):
            if is_dir:
                stack.append(href.rstrip("/") + "/")
                continue
            rel = posixpath.relpath(href, root)
            if Path(rel).name.startswith("index.html"):
                continue
            target = dest / rel
            if target.exists():
                continue
            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(target.suffix + ".tmp")
            with _webdav_request(base_url + href, auth) as resp, \
                    tmp.open("wb") as fb:
                shutil.copyfileobj(resp, fb)
            tmp.rename(target)
            n_files += 1
    return n_files


def download_donders(study: str, dest: Path, parent: str = "dccn",
                     user: tp.Optional[str] = None,
                     password: tp.Optional[str] = None,
                     base_url: str = DONDERS_WEBDAV) -> None:
    """Mirror a Donders repository collection into <dest>/download
    (schoffelen2019's first use).
    Credentials come from arguments or DONDERS_USER/DONDERS_PASSWORD."""
    import os

    dest = Path(dest)
    download_dir = dest / "download"
    success = download_dir / "success.txt"
    if success.exists():
        return
    user = user or os.environ.get("DONDERS_USER")
    password = password or os.environ.get("DONDERS_PASSWORD")
    if not user or not password:
        raise DownloadError(
            "Donders downloads require DONDERS_USER/DONDERS_PASSWORD "
            "credentials (https://data.donders.ru.nl); or mirror the "
            f"collection manually into {download_dir}.")
    logger.info("Mirroring %s/%s/%s -> %s", base_url, parent, study,
                download_dir)
    try:
        n = mirror_webdav(base_url, f"{parent}/{study}", download_dir,
                          user, password)
    except OSError as e:
        raise DownloadError(
            f"Donders webdav mirror of {parent}/{study} failed: {e}. "
            "If this machine has no network egress, fetch the dataset "
            f"on a connected one and place it under {download_dir}."
        ) from e
    success.parent.mkdir(parents=True, exist_ok=True)
    success.write_text(f"download success ({n} files)")
