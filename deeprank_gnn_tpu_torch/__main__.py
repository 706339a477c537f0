from deeprank_gnn_tpu_torch.cli import main

main()
