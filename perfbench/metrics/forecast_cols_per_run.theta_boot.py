"""Series a bootstrap run forecasts or backcasts: the ``columns`` of its
``extend`` spans (what the ``forecast_columns`` counter adds at the same
place), summed over the window's runs and divided by them."""
from perfbench.program_trace import attr_per_run


def read(ctx):
    return attr_per_run(ctx, 'extend', 'bootstrapping', 'columns')
