from kwok_tpu_torch.controllers.controller import Controller  # noqa: F401
from kwok_tpu_torch.controllers.node_controller import NodeController  # noqa: F401
from kwok_tpu_torch.controllers.node_lease_controller import NodeLeaseController  # noqa: F401
from kwok_tpu_torch.controllers.pod_controller import PodController  # noqa: F401
from kwok_tpu_torch.controllers.stage_controller import StageController  # noqa: F401
from kwok_tpu_torch.controllers.stages_manager import StagesManager  # noqa: F401
