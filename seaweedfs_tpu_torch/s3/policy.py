"""Bucket policy engine: an AWS policy-document subset evaluator.

Reference: weed/s3api/policy/ + the bucket policy handlers — the
reference's Identity.canDo is layered under a policy evaluation the same
way. Supported grammar (the subset real tools emit):

  {"Version": "2012-10-17",
   "Statement": [{
       "Effect": "Allow" | "Deny",
       "Principal": "*" | {"AWS": "*" | "arn:aws:iam:::user/<name>" | [..]},
       "Action": "s3:GetObject" | "s3:*" | [..],
       "Resource": "arn:aws:s3:::bucket" | "arn:aws:s3:::bucket/*" | [..]
   }]}

Evaluation order is AWS's: an explicit Deny always wins; an Allow grants
(including to anonymous principals — public buckets); no match falls
through to the identity's own action list. NotAction/NotResource/Condition
are NOT supported and are rejected at PUT time rather than half-enforced.

Counterpart of `seaweedfs_tpu/s3/policy.py`, whole: a policy stored by
either package's gateway evaluates the same in the other's.
"""

from __future__ import annotations

import fnmatch
import json
import logging

log = logging.getLogger("s3.policy")

# coarse internal actions -> the s3 action names checked against policies
ACTION_NAMES = {
    "Read": ["s3:GetObject"],
    "Write": ["s3:PutObject", "s3:DeleteObject"],
    "List": ["s3:ListBucket"],
    "Tagging": ["s3:GetObjectTagging", "s3:PutObjectTagging"],
    "Admin": ["s3:*"],
}


class PolicyError(ValueError):
    pass


def _listify(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


class PolicyDocument:
    def __init__(self, doc: dict):
        self.statements = []
        stmts = doc.get("Statement")
        if not isinstance(stmts, list) or not stmts:
            raise PolicyError("Statement must be a non-empty list")
        for st in stmts:
            if not isinstance(st, dict):
                raise PolicyError("each Statement must be an object")
            unsupported = {"NotAction", "NotResource", "NotPrincipal",
                           "Condition"} & set(st)
            if unsupported:
                raise PolicyError(
                    f"unsupported statement fields: {sorted(unsupported)}")
            effect = st.get("Effect")
            if effect not in ("Allow", "Deny"):
                raise PolicyError(f"bad Effect {effect!r}")
            principal = st.get("Principal", "*")
            if isinstance(principal, dict):
                principals = _listify(principal.get("AWS", []))
            else:
                principals = _listify(principal)
            actions = _listify(st.get("Action"))
            resources = _listify(st.get("Resource"))
            if not actions or not resources:
                raise PolicyError("Action and Resource are required")
            self.statements.append(
                (effect, principals, actions, resources))

    @classmethod
    def parse(cls, raw: bytes | str) -> "PolicyDocument":
        try:
            doc = json.loads(raw)
        except ValueError as e:
            raise PolicyError(f"malformed JSON: {e}") from None
        return cls(doc)

    @staticmethod
    def _principal_matches(principals: list, name: str) -> bool:
        for p in principals:
            if p == "*":
                return True
            if p == name or p.endswith(f":user/{name}") or \
                    p.endswith(f"/{name}"):
                return True
        return False

    def evaluate(self, principal: str, s3_actions: list[str],
                 resource: str) -> str | None:
        """-> "deny" | "allow" | None (no matching statement)."""
        allowed = False
        for effect, principals, actions, resources in self.statements:
            if not self._principal_matches(principals, principal):
                continue
            act_hit = any(fnmatch.fnmatchcase(sa, pat)
                          for sa in s3_actions for pat in actions)
            if not act_hit:
                continue
            res_hit = any(fnmatch.fnmatchcase(resource, pat)
                          for pat in resources)
            if not res_hit:
                continue
            if effect == "Deny":
                return "deny"  # explicit deny always wins
            allowed = True
        return "allow" if allowed else None


class BucketPolicyStore:
    """Per-bucket policy cache over the filer (stored at
    /etc/s3/policies/<bucket>.json, outside any bucket's object listing),
    refreshed with a short TTL like the IAM identity hot-reload."""

    PATH = "/etc/s3/policies"
    TTL = 10.0

    def __init__(self, filer_call):
        # filer_call(method, path, data=None) -> (status, body) coroutine
        self._filer = filer_call
        self._cache: dict[str, tuple[float, PolicyDocument | None]] = {}

    #: sentinel for an unparseable stored document — its (possibly Deny)
    #: statements are unknown, so evaluation must NOT fail open
    BROKEN = "broken"

    async def refresh(self, bucket: str, now: float) -> None:
        hit = self._cache.get(bucket)
        if hit is not None and now - hit[0] < self.TTL:
            return
        try:
            st, body = await self._filer("GET",
                                         f"{self.PATH}/{bucket}.json")
        except Exception as e:
            # a transport error (unreachable filer) must behave exactly
            # like an HTTP 5xx: keep the last known document, else fail
            # closed — never fail open by looking like "no policy"
            log.warning("bucket %s: policy refresh failed (%s)", bucket, e)
            self._cache[bucket] = (now, hit[1] if hit else self.BROKEN)
            return
        if st not in (200, 404):
            # a transient filer error is NOT "no policy": caching absence
            # would silently disable Deny statements for a TTL. Keep the
            # last known document if we have one; otherwise treat the
            # policy as unreadable (fail closed, admin-only).
            log.warning("bucket %s: policy refresh got HTTP %s", bucket, st)
            self._cache[bucket] = (now, hit[1] if hit else self.BROKEN)
            return
        doc = None
        if st == 200 and body:
            try:
                doc = PolicyDocument.parse(body)
            except PolicyError as e:
                # a policy written around put()'s validation (straight to
                # the filer) may have carried Deny statements: dropping it
                # silently would fail OPEN. Deny non-admin access until
                # the document is fixed, and say so.
                log.error("bucket %s: stored policy unparseable (%s); "
                          "denying non-admin access until repaired",
                          bucket, e)
                doc = self.BROKEN
        self._cache[bucket] = (now, doc)

    def get(self, bucket: str):
        hit = self._cache.get(bucket)
        return hit[1] if hit else None

    async def put(self, bucket: str, raw: bytes) -> PolicyDocument:
        doc = PolicyDocument.parse(raw)  # PolicyError -> caller 400s
        st, _ = await self._filer("PUT", f"{self.PATH}/{bucket}.json",
                                  data=raw)
        if st not in (200, 201, 204):
            raise RuntimeError(f"policy store write failed: HTTP {st}")
        self._cache.pop(bucket, None)
        return doc

    async def delete(self, bucket: str) -> None:
        await self._filer("DELETE", f"{self.PATH}/{bucket}.json")
        self._cache.pop(bucket, None)

    def evaluate(self, bucket: str, principal: str, action: str,
                 key: str = "") -> str | None:
        """-> "deny" | "allow" | "broken" | None (no policy / no match)."""
        doc = self.get(bucket)
        if doc is None:
            return None
        if doc is self.BROKEN:
            return self.BROKEN
        names = ACTION_NAMES.get(action, [f"s3:{action}"])
        if key:
            resource = f"arn:aws:s3:::{bucket}/{key}"
        else:
            resource = f"arn:aws:s3:::{bucket}"
        return doc.evaluate(principal, names, resource)
