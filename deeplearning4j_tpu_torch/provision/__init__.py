from deeplearning4j_tpu_torch.provision.cluster import (
    ClusterSpec, ClusterSetup, bootstrap_distributed, HostProvisioner,
)
