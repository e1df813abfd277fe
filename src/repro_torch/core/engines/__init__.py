from repro_torch.core.engines.base import Engine, StepStatus, WorkflowRun
from repro_torch.core.engines.local import LocalEngine
from repro_torch.core.engines.argo import ArgoSubmitter
from repro_torch.core.engines.airflow import AirflowSubmitter
from repro_torch.core.engines.cluster import Cluster, MultiClusterEngine
