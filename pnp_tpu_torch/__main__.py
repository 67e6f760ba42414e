"""``python3 -m pnp_tpu_torch CONFIG``: the command line of the port."""

from .cli import main

raise SystemExit(main())
