"""Minimal AWS-IAM-compatible API: user + access-key CRUD persisted in the
filer, feeding the S3 gateway's identity table.

Reference: weed/iamapi/iamapi_server.go + iamapi_management_handlers.go —
the AWS IAM query protocol (POST form with Action=CreateUser /
CreateAccessKey / ...), identities persisted to the filer at
/etc/iam/identity.json and hot-shared with the S3 gateway.

Counterpart of `seaweedfs_tpu/s3/iamapi_server.py`, whole: the same
actions, XML and identity.json, so an identity file written by either
package's IAM API authenticates in either gateway.  It loads no torch.
"""

from __future__ import annotations

import json
import logging
import secrets
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

import aiohttp
from aiohttp import web

from seaweedfs_tpu_torch.s3.auth import (ACTION_ADMIN, AuthError,
                                         Credential, Identity,
                                         IdentityAccessManagement)
from seaweedfs_tpu_torch.security import jwt
from seaweedfs_tpu_torch.security import tls as _tls
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

log = logging.getLogger("iam")

IAM_XMLNS = "https://iam.amazonaws.com/doc/2010-05-08/"
IDENTITY_PATH = "/etc/iam/identity.json"


def _resp(action: str, fill=None) -> web.Response:
    root = ET.Element(f"{action}Response", xmlns=IAM_XMLNS)
    result = ET.SubElement(root, f"{action}Result")
    if fill is not None:
        fill(result)
    meta = ET.SubElement(root, "ResponseMetadata")
    rid = ET.SubElement(meta, "RequestId")
    rid.text = uuid.uuid4().hex[:16]
    return web.Response(
        body=b'<?xml version="1.0" encoding="UTF-8"?>' +
        ET.tostring(root, encoding="unicode").encode(),
        content_type="application/xml")


def _err(code: str, msg: str, status: int = 400) -> web.Response:
    root = ET.Element("ErrorResponse", xmlns=IAM_XMLNS)
    e = ET.SubElement(root, "Error")
    ET.SubElement(e, "Code").text = code
    ET.SubElement(e, "Message").text = msg
    return web.Response(
        body=b'<?xml version="1.0" encoding="UTF-8"?>' +
        ET.tostring(root, encoding="unicode").encode(),
        status=status, content_type="application/xml")


class IamApiServer:
    def __init__(self, filer_url: str, host: str = "127.0.0.1",
                 port: int = 8111,
                 iam: IdentityAccessManagement | None = None, security=None):
        self.security = security
        self.filer_url = filer_url
        self.host, self.port = host, port
        self.iam = iam or IdentityAccessManagement()
        self.app = web.Application()
        self.app.add_routes([web.post("/", self.handle)])
        self._runner: web.AppRunner | None = None
        self._session: aiohttp.ClientSession | None = None

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=_tls.client_ssl()),
            timeout=aiohttp.ClientTimeout(total=30))
        await self._load()
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port,
                           ssl_context=_tls.server_ssl("iam"))
        await site.start()
        log.info("iam api on %s", self.url)

    async def stop(self) -> None:
        if self._session:
            await self._session.close()
        if self._runner:
            await self._runner.cleanup()

    # -- persistence ---------------------------------------------------

    def _auth(self, write: bool) -> dict:
        if self.security is None:
            return {}
        key = self.security.filer_write if write else self.security.filer_read
        if not key:
            return {}
        return {"Authorization": "Bearer " + jwt.gen_jwt(key, "")}

    async def _load(self) -> None:
        try:
            async with self._session.get(
                    f"{_tls_scheme()}://{self.filer_url}{IDENTITY_PATH}",
                    headers=self._auth(write=False)) as r:
                if r.status == 200:
                    data = json.loads(await r.read())
                    self.iam.replace_identities(
                        IdentityAccessManagement.from_config(data).identities)
        except aiohttp.ClientError:
            pass

    async def _save(self) -> None:
        data = {"identities": [
            {"name": i.name,
             "credentials": [{"accessKey": c.access_key,
                              "secretKey": c.secret_key}
                             for c in i.credentials],
             "actions": i.actions}
            for i in self.iam.identities]}
        async with self._session.put(
                f"{_tls_scheme()}://{self.filer_url}{IDENTITY_PATH}",
                data=json.dumps(data, indent=1).encode(),
                headers=self._auth(write=True)) as r:
            if r.status >= 300:
                raise RuntimeError(f"filer save: {r.status}")

    def _find(self, name: str) -> Identity | None:
        return next((i for i in self.iam.identities if i.name == name), None)

    # -- dispatch ------------------------------------------------------

    async def handle(self, req: web.Request) -> web.Response:
        # SigV4-authenticated, Admin-only once an identity exists that holds
        # Admin with credentials; before that the API is open for bootstrap
        # (the reference's weed/iamapi authenticates management calls with
        # the s3 gateway's identities the same way).
        if any(ACTION_ADMIN in i.actions and i.credentials
               for i in self.iam.identities):
            raw_path = req.raw_path.split("?", 1)[0]
            q = {k: req.query.get(k, "") for k in req.query}
            try:
                ident = self.iam.authenticate(req.method, raw_path, q,
                                              req.headers)
            except AuthError as e:
                return _err(e.code, str(e), e.status)
            if not ident.can_do(ACTION_ADMIN):
                return _err("AccessDenied",
                            "IAM management requires Admin", 403)
            raw_body = await req.read()
            try:
                # the signature covered x-amz-content-sha256; reject a
                # replayed header set with a swapped Action body
                self.iam.verify_payload_hash(req.headers, raw_body)
            except AuthError as e:
                return _err(e.code, str(e), e.status)
        else:
            raw_body = await req.read()
        form = urllib.parse.parse_qs(raw_body.decode())
        values = {k: v[0] for k, v in form.items()}
        action = values.get("Action", "")
        handler = getattr(self, f"do_{action}", None)
        if handler is None:
            return _err("InvalidAction", f"unsupported action {action!r}",
                        400)
        return await handler(values)

    async def do_ListUsers(self, v) -> web.Response:
        def fill(result):
            users = ET.SubElement(result, "Users")
            for i in self.iam.identities:
                m = ET.SubElement(users, "member")
                ET.SubElement(m, "UserName").text = i.name
        return _resp("ListUsers", fill)

    async def do_CreateUser(self, v) -> web.Response:
        name = v.get("UserName", "")
        if not name:
            return _err("InvalidInput", "UserName required")
        if self._find(name):
            return _err("EntityAlreadyExists", f"user {name} exists", 409)
        self.iam.identities.append(Identity(name=name))
        await self._save()

        def fill(result):
            u = ET.SubElement(result, "User")
            ET.SubElement(u, "UserName").text = name
        return _resp("CreateUser", fill)

    async def do_GetUser(self, v) -> web.Response:
        name = v.get("UserName", "")
        ident = self._find(name)
        if ident is None:
            return _err("NoSuchEntity", f"user {name} not found", 404)

        def fill(result):
            u = ET.SubElement(result, "User")
            ET.SubElement(u, "UserName").text = ident.name
        return _resp("GetUser", fill)

    async def do_DeleteUser(self, v) -> web.Response:
        name = v.get("UserName", "")
        ident = self._find(name)
        if ident is None:
            return _err("NoSuchEntity", f"user {name} not found", 404)
        self.iam.identities.remove(ident)
        await self._save()
        return _resp("DeleteUser")

    async def do_CreateAccessKey(self, v) -> web.Response:
        name = v.get("UserName", "")
        ident = self._find(name)
        if ident is None:
            ident = Identity(name=name)
            self.iam.identities.append(ident)
        cred = Credential(access_key=secrets.token_hex(10).upper(),
                          secret_key=secrets.token_urlsafe(30))
        ident.credentials.append(cred)
        await self._save()

        def fill(result):
            k = ET.SubElement(result, "AccessKey")
            ET.SubElement(k, "UserName").text = name
            ET.SubElement(k, "AccessKeyId").text = cred.access_key
            ET.SubElement(k, "SecretAccessKey").text = cred.secret_key
            ET.SubElement(k, "Status").text = "Active"
        return _resp("CreateAccessKey", fill)

    async def do_DeleteAccessKey(self, v) -> web.Response:
        ak = v.get("AccessKeyId", "")
        for ident in self.iam.identities:
            for cred in ident.credentials:
                if cred.access_key == ak:
                    ident.credentials.remove(cred)
                    await self._save()
                    return _resp("DeleteAccessKey")
        return _err("NoSuchEntity", "access key not found", 404)

    async def do_ListAccessKeys(self, v) -> web.Response:
        name = v.get("UserName", "")

        def fill(result):
            keys = ET.SubElement(result, "AccessKeyMetadata")
            for ident in self.iam.identities:
                if name and ident.name != name:
                    continue
                for cred in ident.credentials:
                    m = ET.SubElement(keys, "member")
                    ET.SubElement(m, "UserName").text = ident.name
                    ET.SubElement(m, "AccessKeyId").text = cred.access_key
                    ET.SubElement(m, "Status").text = "Active"
        return _resp("ListAccessKeys", fill)

    async def do_PutUserPolicy(self, v) -> web.Response:
        """Map a policy document's s3 action verbs onto the identity's
        action list (simplified policy engine; reference maps the same
        verbs in iamapi_management_handlers.go GetActions)."""
        name = v.get("UserName", "")
        ident = self._find(name)
        if ident is None:
            return _err("NoSuchEntity", f"user {name} not found", 404)
        try:
            doc = json.loads(v.get("PolicyDocument", "{}"))
        except ValueError:
            return _err("MalformedPolicyDocument", "bad json")
        actions: set[str] = set(ident.actions)
        for stmt in doc.get("Statement", []):
            acts = stmt.get("Action", [])
            if isinstance(acts, str):
                acts = [acts]
            for a in acts:
                if a in ("s3:*", "*"):
                    actions.add("Admin")
                elif a in ("s3:GetObject",):
                    actions.add("Read")
                elif a in ("s3:PutObject", "s3:DeleteObject"):
                    actions.add("Write")
                elif a in ("s3:ListBucket", "s3:ListAllMyBuckets"):
                    actions.add("List")
                elif a.endswith("Tagging"):
                    actions.add("Tagging")
        ident.actions = sorted(actions)
        await self._save()
        return _resp("PutUserPolicy")
