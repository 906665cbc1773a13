from .sharded import (  # noqa: F401
    ViewGroup,
    group_size,
    make_view_group,
    sharded_candidate_utility,
    sharded_train_step,
    sharded_view_bins,
    view_share,
)
