from grove_tpu_torch.initc.agent import (  # noqa: F401
    Requirement,
    http_fetch,
    parse_podcliques_arg,
    store_fetch,
    wait_until_ready,
)
