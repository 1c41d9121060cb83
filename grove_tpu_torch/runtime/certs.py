"""Cert management for the manager's HTTP surface.

The reference manages webhook TLS with the cert-controller rotator (auto
mode: generate + rotate a self-signed CA and serving cert) or externally
provided certs (manual mode), and blocks readiness until certs are ready
(`internal/controller/cert/cert.go:46-98`,
`api/config/v1alpha1/types.go:154-169`). This stack's inbound surface is the
manager HTTP API (probes + object API + initc endpoint) instead of an
admission webhook; the same two modes apply:

  auto    — generate a self-signed serving cert into `cert_dir` at boot
            (reused while >10% of its lifetime remains), openssl-backed
  manual  — operator-provided cert/key paths, validated at boot

The generated cert doubles as the CA bundle clients pin (self-signed), the
in-cluster analog of the rotator writing the CA into the webhook config.
"""

from __future__ import annotations

import os
import pathlib
import subprocess


class CertError(Exception):
    pass


def ensure_serving_certs(
    mode: str,
    cert_dir: str,
    *,
    cert_file: str = "",
    key_file: str = "",
    common_name: str = "grove-tpu-manager",
    days: int = 365,
    san_dns: tuple[str, ...] = (),
) -> tuple[str, str]:
    """Return (cert_path, key_path) ready to serve, per the configured mode.

    Raises CertError when manual files are missing or generation fails —
    the boot contract mirrors the reference: no serving without certs.
    """
    if mode == "manual":
        for label, path in (("certFile", cert_file), ("keyFile", key_file)):
            if not path or not pathlib.Path(path).is_file():
                raise CertError(f"tls mode manual: {label} {path!r} not found")
        return cert_file, key_file
    if mode != "auto":
        raise CertError(f"unknown tls mode {mode!r} (want auto|manual)")

    out = pathlib.Path(cert_dir)
    out.mkdir(parents=True, exist_ok=True, mode=0o700)
    # The dir may pre-exist (shared /tmp is a predictable path): refuse one
    # we don't own — an attacker-planted key there would MITM the
    # bearer-token API — and close group/world access on ours.
    st = out.stat()
    if st.st_uid != os.getuid():
        raise CertError(f"cert dir {out} is owned by uid {st.st_uid}, not us")
    os.chmod(out, 0o700)
    cert = out / "tls.crt"
    key = out / "tls.key"
    # SANs are baked into the cert: if the requested set changed (e.g. a
    # webhook Service DNS name was added to the config), the cached cert is
    # stale even while time-valid — track the set in a sidecar marker.
    san = "subjectAltName=" + ",".join(
        ["DNS:localhost", "IP:127.0.0.1"] + [f"DNS:{d}" for d in san_dns]
    )
    san_marker = out / "san.txt"
    if san_marker.is_file():
        san_current = san_marker.read_text()
    else:
        # Pre-marker certs were all generated with the bare default SAN set:
        # treat a missing marker as that set (and stamp it on reuse below) so
        # upgrading does not churn a still-valid cert that pinned clients
        # (initc agents, GroveClients) already trust.
        san_current = "subjectAltName=DNS:localhost,IP:127.0.0.1"
    if (
        cert.is_file()
        and key.is_file()
        and _still_valid(cert, days)
        and san_current == san
    ):
        if not san_marker.is_file():
            san_marker.write_text(san)
        os.chmod(key, 0o600)
        return str(cert), str(key)
    try:
        proc = subprocess.run(
            [
                "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                "-keyout", str(key), "-out", str(cert),
                "-days", str(days),
                "-subj", f"/CN={common_name}",
                "-addext", san,
            ],
            capture_output=True,
            text=True,
        )
    except OSError as e:  # openssl missing: keep the CertError boot contract
        raise CertError(f"cannot run openssl: {e}") from e
    if proc.returncode != 0:
        raise CertError(f"self-signed cert generation failed: {proc.stderr.strip()}")
    san_marker.write_text(san)
    os.chmod(key, 0o600)
    return str(cert), str(key)


def pinned_client_context(cafile: str):
    """ssl context trusting exactly the pinned serving cert (auto mode's
    self-signed cert doubles as the CA bundle). Hostname checking is off —
    the pin itself is the trust anchor. The ONE place the client-side TLS
    policy lives (GroveClient and the initc agent both use it)."""
    import ssl

    ctx = ssl.create_default_context(cafile=cafile)
    ctx.check_hostname = False
    return ctx


def _still_valid(cert: pathlib.Path, days: int) -> bool:
    """True while >10% of the requested lifetime remains (rotation point)."""
    margin_s = int(days * 24 * 3600 * 0.1)
    proc = subprocess.run(
        ["openssl", "x509", "-checkend", str(margin_s), "-noout", "-in", str(cert)],
        capture_output=True,
    )
    return proc.returncode == 0
