"""Edge-based Data Science pipeline services (paper §3, Fig. 1-2).

Services implement big data/stream operators (aggregation, analytics) and
compose into pipelines by data-flow mash-up. Each service follows the
paper's architecture: Fetch → buffer (with a data-management strategy) →
OperatorLogic → Sink, driven by a recurrence scheduler. The broker, the
services and the store are the edge tier and run on the host; a window
that outgrows the edge spills just in time to the VDC, the CUDA card
(queries.py).
"""
from repro_torch.pipeline.streams import Broker, StreamProducer, NeubotFarm
from repro_torch.pipeline.store import TimeSeriesStore
from repro_torch.pipeline.service import StreamService, ServiceConfig
from repro_torch.pipeline.operators import (WindowSpec, aggregate, kmeans,
                                            linear_regression)
from repro_torch.pipeline.composition import Pipeline
from repro_torch.pipeline.queries import (neubot_query_1, neubot_query_2,
                                          HybridExecutor)
