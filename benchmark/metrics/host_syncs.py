"""Host-device synchronisations inside the call into the port, a query,
counted by `torch.cuda.set_sync_debug_mode` over the sync stretch."""


def read(run):
    return sum(run.syncs) / len(run.syncs) if run.syncs else None
