"""FTP gateway stub (reference: weed/ftpd/ftp_server.go — an 81-line stub
in the reference too: option struct + a Run that errors pending a real
implementation).  Counterpart of `seaweedfs_tpu/ftpd.py`, with the same
text: kept as the registration seam so an FTP library can slot in
without touching callers."""

from __future__ import annotations


class FtpServerOption:
    def __init__(self, filer_url: str, host: str = "127.0.0.1",
                 port: int = 8021, passive_port_start: int = 30000,
                 passive_port_stop: int = 30100):
        self.filer_url = filer_url
        self.host, self.port = host, port
        self.passive_port_start = passive_port_start
        self.passive_port_stop = passive_port_stop


class FtpServer:
    def __init__(self, option: FtpServerOption):
        self.option = option

    async def start(self) -> None:
        raise NotImplementedError(
            "the FTP gateway is a stub (as in the reference's weed/ftpd); "
            "use the S3, WebDAV, or mount gateways")
