"""ladder.rungs_per_batch: the mean number of rungs the serving ladder
(``retrieval/searcher.py`` ``supertile_ladder``, ``tile_ladder`` or
``impact_ladder``) ran a batch in the traced window, as each returned it."""


def read(run):
    if not run.rungs:
        return None
    return sum(run.rungs) / len(run.rungs)
