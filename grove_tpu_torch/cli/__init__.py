"""kubectl-plugin-style CLI over the manager's object API (grove_tpu/cli
counterpart).

The reference reserves `cli-plugin/` for exactly this surface (upstream it is
an empty module stub); here it is real: `python -m grove_tpu_torch.cli`
speaks to a running manager through the typed client (client/typed.py) and
renders kubectl-shaped output — `get` tables, get-by-name JSON, `apply -f`,
`delete`, `events`.
"""

from grove_tpu_torch.cli.main import main

__all__ = ["main"]
