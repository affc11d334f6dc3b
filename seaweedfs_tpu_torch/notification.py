"""Notification bus: publish filer meta events to an external queue.

Counterpart of `seaweedfs_tpu/notification.py` (reference:
weed/notification/configuration.go and its kafka, aws_sqs, gcp_pub_sub
and log backends), whole: the JSONL `LogQueue`, whose lines the replicate
daemon's `LogFileSource` tails (the same bytes as the reference's, so
either package's daemon reads either package's log), the in-memory
`MemoryQueue`, the `WebhookQueue` with its drain thread, and the
broker-backed queues, each registered only where its client library
imports (none does on this host).  The filer server publishes its meta
events to whichever queue it is given (`-notification.log`,
`-notification.webhook`).  No torch is loaded.

`WebhookQueue.close` joins its drain thread (the reference's sets a flag
and returns, leaving the thread to notice within half a second).
"""

from __future__ import annotations

import json
import logging
import threading
from collections import deque

log = logging.getLogger("notification")


class MessageQueue:
    name = "abstract"

    def send(self, key: str, message: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LogQueue(MessageQueue):
    """Append events to a JSONL file (reference: notification `log`
    backend)."""

    name = "log"

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def send(self, key: str, message: dict) -> None:
        line = json.dumps({"key": key, **message}, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


class MemoryQueue(MessageQueue):
    name = "memory"

    def __init__(self, maxlen: int = 65536):
        self.messages: deque = deque(maxlen=maxlen)
        self.sent = 0  # total ever sent: lets consumers detect eviction
        # keeps (messages, sent) consistent for consumers that snapshot
        # both (replicate_daemon.MemorySource): append + increment is not
        # atomic, and a consumer catching the gap mis-offsets every event
        # after an eviction
        self.lock = threading.Lock()

    def send(self, key: str, message: dict) -> None:
        with self.lock:
            self.messages.append((key, message))
            self.sent += 1


class WebhookQueue(MessageQueue):
    """POST each event to an HTTP endpoint (the gocdk/webhook-style
    backend) — SDK-free, works against any collector, retried with
    backoff like the replication sinks.

    Delivery runs on an internal worker thread behind a bounded queue:
    `send()` is called synchronously from the filer's event loop, so a
    slow/down collector must never block file operations. Overflow drops
    the oldest events (logged) — same at-most-once posture as the
    reference's fire-and-forget notification publishers."""

    name = "webhook"

    def __init__(self, url: str, timeout: float = 10.0,
                 max_pending: int = 10000):
        import logging
        import queue as _queue
        self.url = url
        self.timeout = timeout
        self._log = logging.getLogger("notification.webhook")
        self._q: _queue.Queue = _queue.Queue(maxsize=max_pending)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._drain, daemon=True,
                                        name="webhook-notify")
        self._worker.start()

    def send(self, key: str, message: dict) -> None:
        item = json.dumps({"key": key, **message},
                          separators=(",", ":")).encode()
        try:
            self._q.put_nowait(item)
        except Exception:
            try:  # full: drop the oldest so fresh events keep flowing
                self._q.get_nowait()
                self._q.put_nowait(item)
                self._log.warning("webhook queue full; dropped oldest event")
            except Exception:
                pass

    def _drain(self) -> None:
        import urllib.request

        from seaweedfs_tpu_torch.replication.sink import retry
        while not self._stop.is_set():
            try:
                body = self._q.get(timeout=0.5)
            except Exception:
                continue
            req = urllib.request.Request(
                self.url, data=body, method="POST",
                headers={"Content-Type": "application/json"})

            def post():
                with urllib.request.urlopen(req, timeout=self.timeout):
                    pass
            try:
                retry(post, attempts=3)
            except Exception as e:
                self._log.warning("webhook delivery failed, event lost: %s",
                                  e)

    def close(self) -> None:
        deadline = 5.0
        import time as _time
        end = _time.monotonic() + deadline
        while not self._q.empty() and _time.monotonic() < end:
            _time.sleep(0.05)
        self._stop.set()
        self._worker.join(5)


class KafkaQueue(MessageQueue):
    """Kafka producer backend (reference: weed/notification/kafka);
    registers only when a kafka client package imports."""

    name = "kafka"

    def __init__(self, hosts: str = "127.0.0.1:9092", topic: str = "seaweedfs"):
        from kafka import KafkaProducer
        self.topic = topic
        self._producer = KafkaProducer(
            bootstrap_servers=[h.strip() for h in hosts.split(",")],
            value_serializer=lambda m: json.dumps(
                m, separators=(",", ":")).encode())

    def send(self, key: str, message: dict) -> None:
        self._producer.send(self.topic, key=key.encode(),
                            value={"key": key, **message})

    def close(self) -> None:
        self._producer.flush()
        self._producer.close()


class SqsQueue(MessageQueue):
    """AWS SQS backend (reference: weed/notification/aws_sqs); registers
    only when boto3 imports."""

    name = "aws_sqs"

    def __init__(self, queue_url: str, region: str = "us-east-1"):
        import boto3
        self.queue_url = queue_url
        self._sqs = boto3.client("sqs", region_name=region)

    def send(self, key: str, message: dict) -> None:
        self._sqs.send_message(
            QueueUrl=self.queue_url,
            MessageBody=json.dumps({"key": key, **message},
                                   separators=(",", ":")))


class GooglePubSubQueue(MessageQueue):
    """GCP Pub/Sub backend (reference: weed/notification/google_pub_sub);
    registers only when google-cloud-pubsub imports."""

    name = "google_pub_sub"

    def __init__(self, project_id: str, topic: str = "seaweedfs"):
        from google.cloud import pubsub_v1
        self._publisher = pubsub_v1.PublisherClient()
        self._topic = self._publisher.topic_path(project_id, topic)

    def send(self, key: str, message: dict) -> None:
        future = self._publisher.publish(
            self._topic,
            json.dumps({"key": key, **message},
                       separators=(",", ":")).encode(),
            key=key)
        # publish() batches and resolves later: surface failures instead
        # of dropping events silently
        future.add_done_callback(
            lambda f: f.exception() and log.warning(
                "pubsub event lost for %s: %s", key, f.exception()))

    def close(self) -> None:
        # flush the batched tail before shutdown (KafkaQueue parity)
        self._publisher.stop()


QUEUES = {"log": LogQueue, "memory": MemoryQueue, "webhook": WebhookQueue}

# SDK-gated backends, mirroring the reference's build-tag registration
try:
    import kafka  # noqa: F401
    QUEUES["kafka"] = KafkaQueue
except ImportError:
    pass
try:
    import boto3  # noqa: F401
    QUEUES["aws_sqs"] = SqsQueue
except ImportError:
    pass
try:
    from google.cloud import pubsub_v1  # noqa: F401
    QUEUES["google_pub_sub"] = GooglePubSubQueue
except ImportError:
    pass


def make_queue(kind: str, **options) -> MessageQueue:
    try:
        return QUEUES[kind](**options)
    except KeyError:
        raise ValueError(f"unknown notification queue {kind!r} "
                         f"(have {sorted(QUEUES)}; kafka/sqs/pubsub need "
                         f"their client libraries)")
