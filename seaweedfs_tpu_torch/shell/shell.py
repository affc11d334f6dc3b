"""Interactive admin shell (reference: weed/shell/shell.go REPL).

Counterpart of `seaweedfs_tpu/shell/shell.py`, whole.
"""

from __future__ import annotations

import sys

from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command


def _setup_completion() -> None:
    """Tab-completes command names (reference: the shell's
    prompt autocompletion, weed/shell/shell.go + weed autocomplete)."""
    try:
        import readline
    except ImportError:  # no libreadline: plain input() still works
        return
    from seaweedfs_tpu_torch.shell.commands import COMMANDS

    def complete(text: str, state: int):
        matches = [c for c in sorted(COMMANDS) if c.startswith(text)]
        return matches[state] if state < len(matches) else None

    readline.set_completer(complete)
    readline.set_completer_delims(" \t")
    readline.parse_and_bind("tab: complete")


def repl(master: str, script: str | None = None) -> int:
    env = CommandEnv(master)
    rc = 0
    try:
        if script is not None:
            for line in script.split(";"):
                line = line.strip()
                if line:
                    # a command's nonzero rc (volume.fsck on a corrupt
                    # cluster) must surface as the process exit code so
                    # CI/chaos harnesses can gate on `weedtpu shell -c`
                    rc = max(rc, run_command(env, line, sys.stdout))
            return rc
        _setup_completion()
        while True:
            try:
                line = input("> ").strip()
            except EOFError:
                break
            if line in ("exit", "quit"):
                break
            if not line:
                continue
            try:
                run_command(env, line, sys.stdout)
            except RuntimeError as e:
                print(f"error: {e}", file=sys.stderr)
    finally:
        try:
            env.release_lock()
        except RuntimeError:
            pass
    return rc
