from gdpathtracing_torch.cli import main

main()
