"""flink_tpu_torch.scheduler"""
