"""Host syncs the dispatch thread made in the window (`utils.device.
count_syncs`, the pose writer's thread left out), per frame."""


def read(run):
    syncs = run["counters"].get("dispatch_syncs")
    if syncs is None or not run["frames"]:
        return None
    return syncs / len(run["frames"])
