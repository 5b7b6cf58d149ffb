"""Launchers of the port (``serve``, ``train``, ``dryrun``) and the mesh
layer (``mesh``) they run on."""
from repro_torch.launch.mesh import (COORD_ADDR_ENV, NUM_PROCESSES_ENV,
                                     PROCESS_ID_ENV, SCENARIO_AXIS,
                                     ScenarioMesh, distributed_env,
                                     ensure_distributed, make_local_mesh,
                                     make_production_mesh,
                                     make_scenario_mesh, pod_mesh,
                                     process_slice, resolve_mesh)

__all__ = ["SCENARIO_AXIS", "COORD_ADDR_ENV", "NUM_PROCESSES_ENV",
           "PROCESS_ID_ENV", "ScenarioMesh", "distributed_env",
           "ensure_distributed", "process_slice", "resolve_mesh",
           "pod_mesh", "make_scenario_mesh", "make_production_mesh",
           "make_local_mesh"]
