"""Async replication: meta-event-driven sinks + filer.sync
(reference: weed/replication/, weed/command/filer_sync.go)."""
