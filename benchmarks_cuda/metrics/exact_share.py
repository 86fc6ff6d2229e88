"""exact_share: the share (%) of the checked queries whose served top-k
equals the plain reference's: every served document's reference score
within the limits of the check, rank by rank, and k of them."""


def read(run):
    if not run.checked_rows:
        return None
    return 100.0 * run.exact_rows / run.checked_rows
